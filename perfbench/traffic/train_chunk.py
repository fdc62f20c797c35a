"""Traffic driver: closed-loop fused training, synthesize -> train step
replayed as the port's captured chunk.

The traffic file gives the scene ("anechoic" over an HRIR bank, or
"spirit" over a BRIR bank), the batch, the steps per chunk, the bank's
and the speech pool's sizes, the checked steps and the traced chunks.
One run: set-up builds the program's synthesizer, model, optimizer and
chunk (``biear_tpu_torch.train.loop.make_train_chunk``) from the seed's
inputs and weights, captures it, and drives it through the checked
steps by the chunk's own call; the window replays whole chunks, each
ending in a synchronise, and counts utterances over its wall time.
After the window the program's state is freed and the plain reference
(``perfbench/reference``) repeats the checked steps from the same seed.

Readings (those the cell's file gives a limit are compared):
  * loss_gap: the largest relative gap of a checked step's loss;
  * grad_gap: the first update the optimizer takes in (clipped gradient
    plus weight decay, read from Adam's first moment after step 1), the
    worst leaf's |norm - reference norm| over max(reference norm, the
    median leaf's reference norm); grad_gap_median: the median leaf's;
    grad_gap_q25: the first-quartile leaf's (the bfloat16 filterbank's
    rounding flips are sparse and move a few leaves far, while a lower
    precision of the float32 products moves every leaf a little: the
    quiet quarter of the leaves shows the latter);
  * grad_diff: the norm of the difference of the whole first update
    over the reference's norm (every leaf together);
  * change_gap, change_gap_median: the same for each leaf's change over
    the checked steps, over the leaves whose reference gradient is above
    a thousandth of the median leaf's (the others move by rounding
    alone).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import devtrace, inputs
from perfbench import bounds
from perfbench.reference import model as ref_model
from perfbench.reference import synth as ref_synth
from perfbench.reference.train import B1, Trainer

FLOP_ROWS = 2


def ref_config(config: dict) -> dict:
    """The reference's view of a configuration: the model's fields, the
    family and the filterbank operand policy."""
    return dict(config["model"], family=config["family"],
                fb_w_dtype=config["policy"]["fb_w_dtype"])


class Cell:
    kind = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: bool = False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.control = control
        self.B = int(traffic["batch"])
        self.steps = int(traffic["chunk_steps"])
        self.cfg = ref_config(config)
        self.sync = ((lambda: torch.cuda.synchronize(self.device))
                     if self.device.type == "cuda" else (lambda: None))

    # ---------------- inputs ----------------

    def scene_inputs(self) -> dict:
        t, fs, seed = self.traffic, self.cfg["fs"], self.seed
        segs = inputs.speech_pool(seed, int(t["segments"]),
                                  int(t["segment_samples"]), fs)
        if t["scene"] == "anechoic":
            h = t["hrir"]
            ir, az, dist = inputs.hrir_bank(seed, int(h["azimuths"]),
                                            h["distances"], int(h["taps"]),
                                            fs)
            return {"scene": "anechoic", "ir": ir, "az": az, "dist": dist,
                    "segments": segs}
        b = t["brir"]
        ir, yaw, xy = inputs.brir_bank(seed, b["speakers"], int(b["n_yaw"]),
                                       int(b["taps"]), fs)
        return {"scene": "spirit", "ir": ir, "yaw": yaw, "xy": xy,
                "segments": segs}

    def weights(self) -> dict:
        return ref_model.make_params(
            ref_model.param_specs(self.cfg),
            inputs.device_gen(self.seed, "weights", self.device))

    # ---------------- the program ----------------

    def setup(self, seconds: float = 0.0) -> None:
        from biear_tpu_torch.data.synth import AnechoicSynthesizer
        from biear_tpu_torch.data.synth_reverb import ReverbSynthesizer
        from biear_tpu_torch.device import apply_matmul_precision
        from biear_tpu_torch.models import (BiEARConfig, build_active,
                                            build_auralnet)
        from biear_tpu_torch.train.loop import make_train_chunk
        from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

        t0 = time.perf_counter()
        conf, pol = self.config, self.config["policy"]
        apply_matmul_precision("tensorfloat32" if self.control
                               else pol["matmul_precision"])
        mcfg = BiEARConfig(**conf["model"], fb_w_dtype=pol["fb_w_dtype"])
        hp = {k: v for k, v in conf["train"].items() if k != "max_param_log"}
        self.hp = TrainHyper(**hp)
        self.inp = x = self.scene_inputs()
        t1 = time.perf_counter()
        fs, N = self.cfg["fs"], self.cfg["n_bands"]
        if x["scene"] == "anechoic":
            self.synth = AnechoicSynthesizer(
                x["ir"], x["az"], x["dist"], x["segments"], fs=fs,
                num_lags=N, mix_dtype=pol["mix_dtype"], device=self.device)
        else:
            self.synth = ReverbSynthesizer(x["ir"], x["yaw"], x["xy"],
                                           x["segments"], fs=fs, num_lags=N,
                                           device=self.device)
        t2 = time.perf_counter()
        build = build_auralnet if conf["family"] == "auralnet" else build_active
        self.model = build(mcfg, seed=0, device=self.device)
        self.theta0 = self.weights()
        self.model.load_state_dict(self.theta0, strict=True)
        self.opt = make_optimizer(self.model, self.hp)
        self.max_param_log = int(conf["train"]["max_param_log"])
        self.make_chunk = lambda n: make_train_chunk(
            self.model, self.hp, self.opt, self.synth.batch_fn(self.B), n,
            self.max_param_log)
        self.chunk = self.make_chunk(self.steps)
        self.gen = inputs.device_gen(self.seed, "train", self.device)
        t3 = time.perf_counter()
        if hasattr(self.chunk, "capture"):
            self.chunk.capture(self.gen)
        t4 = time.perf_counter()
        self.checked = self.checked_steps(int(self.traffic["checked_steps"]))
        self.setup_phases = {"inputs": t1 - t0, "synthesizer": t2 - t1,
                             "model": t3 - t2, "capture": t4 - t3,
                             "checked_steps": time.perf_counter() - t4}

    def run_steps(self, n: int) -> dict:
        """n synthesize -> train steps through the window's chunk call
        (the captured chunk replayed n times; on the CPU an eager chunk
        of n steps over the same model, optimizer and synthesizer)."""
        if hasattr(self.chunk, "chunk_steps"):
            saved, self.chunk.chunk_steps = self.chunk.chunk_steps, n
            try:
                out = self.chunk(self.gen)
            finally:
                self.chunk.chunk_steps = saved
        else:
            out = self.make_chunk(n)(self.gen)
        return {k: v[:n] for k, v in out.items()}

    def adam_updates(self) -> dict:
        """Each leaf's first update u = m / (1 - b1), read from Adam's first
        moment after one step."""
        return {n: (m / (1.0 - B1)).detach().clone()
                for g in self.opt.groups if not g.frozen
                for n, m in zip(g.names, g.m)}

    def checked_steps(self, n: int) -> dict:
        first = self.run_steps(1)
        u1 = self.adam_updates()
        rest = self.run_steps(n - 1) if n > 1 else {}
        losses = [float(first["loss"][0])] + [float(v) for v in
                                              rest.get("loss", [])]
        skipped = float(first["skipped"].sum()) + float(
            rest["skipped"].sum() if rest else 0.0)
        params = dict(self.model.named_parameters())
        change = {k: (params[k].detach() - self.theta0[k]).clone()
                  for k in self.theta0}
        return {"losses": losses, "u1": u1, "change": change,
                "skipped": skipped}

    def window(self, seconds: float) -> dict:
        """Whole chunks until `seconds` have passed, each synchronised."""
        skipped, marks = [], []
        self.sync()
        t0 = t = time.perf_counter()
        while True:
            skipped.append(self.chunk(self.gen)["skipped"].sum())
            queued = time.perf_counter()
            self.sync()
            marks.append((queued - t, time.perf_counter() - t))
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        wall = t - t0
        steps = len(marks) * self.steps
        # per chunk: the host's time to queue it, and its whole time
        q, c = (np.round(1e3 * np.array(v), 1).tolist() for v in zip(*marks))
        return {"wall_s": wall, "utt": steps * self.B, "attempted": steps,
                "failed": int(round(float(torch.stack(skipped).sum()))),
                "info": {"chunks": len(marks), "queue_ms": q, "chunk_ms": c}}

    def traced(self) -> dict:
        """The traced window: whole chunks under torch.profiler."""
        n = int(self.traffic["traced_chunks"])
        tr = devtrace.trace(lambda: [self.chunk(self.gen) for _ in range(n)])
        return {"trace": tr, "traced_utt_s": n * self.steps * self.B
                / tr["wall_s"], "traced_steps": n * self.steps}

    def stages(self) -> dict:
        """Device busy ms of each eager stage of one step (after the
        traced window; the update lands on the program's state), and the
        step's FLOPs per utterance."""
        from biear_tpu_torch.device import matmul_precision
        from biear_tpu_torch.train.loop import apply_update, model_loss

        gen = inputs.device_gen(self.seed, "stages", self.device)
        model, params = self.model, list(self.model.parameters())
        model.train()
        batch = self.synth.sample_batch(gen, self.B)

        def fwd():
            with matmul_precision():
                return model_loss(model, self.hp, batch, gen)
        loss, metrics = fwd()
        with matmul_precision():
            grads = torch.autograd.grad(loss, params, retain_graph=True)

        def bwd():
            with matmul_precision():
                return torch.autograd.grad(loss, params, retain_graph=True)
        weight = torch.tensor(float(self.B), device=self.device)
        stages = {
            "synthesis": devtrace.stage_busy_ms(
                lambda: self.synth.sample_batch(gen, self.B)),
            "forward": devtrace.stage_busy_ms(fwd),
            "backward": devtrace.stage_busy_ms(bwd),
            "optimizer": devtrace.stage_busy_ms(
                lambda: apply_update(model, self.opt, list(grads),
                                     dict(metrics), weight, 1.0,
                                     self.max_param_log))}
        return {"stages_busy_ms": stages,
                "flops_per_utt": self.flops_per_utt()}

    def flops_per_utt(self) -> float:
        """The products of one forward and backward of the reference model
        on FLOP_ROWS rows on the CPU (``bounds.train_flops_per_utt``)."""
        cfg, cpu = self.cfg, torch.device("cpu")
        P = {k: v.detach().to(cpu).requires_grad_(True)
             for k, v in self.theta0.items()}
        c = ref_model.constants(cfg, cpu)
        g = torch.Generator().manual_seed(0)
        wav = torch.rand((2, FLOP_ROWS, cfg["fs"]), generator=g) * 2 - 1
        x3 = torch.rand((FLOP_ROWS, cfg["n_bands"]), generator=g)
        y = torch.zeros((FLOP_ROWS, ref_model.N_SECTORS * 7))
        hp = self.config["train"]
        return bounds.train_flops_per_utt(
            lambda: (ref_model.loss(cfg, hp, c, P, (wav[0], wav[1], x3, y),
                                    g), list(P.values())), FLOP_ROWS)

    def release(self) -> None:
        for k in ("chunk", "model", "opt", "synth", "make_chunk"):
            self.__dict__.pop(k, None)
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------- the reference ----------------

    def reference(self):
        x = self.inp
        fs, N = self.cfg["fs"], self.cfg["n_bands"]
        if x["scene"] == "anechoic":
            scene = ref_synth.Anechoic(x["ir"], x["az"], x["dist"],
                                       x["segments"], fs, N,
                                       self.config["policy"]["mix_dtype"],
                                       self.device)
        else:
            scene = ref_synth.Spirit(x["ir"], x["yaw"], x["xy"],
                                     x["segments"], fs, N, self.device)
        return Trainer(self.cfg, self.config["train"], self.theta0, scene,
                       self.device)

    def check(self) -> dict:
        """The compared numbers (see the module's text) and, for the
        readers, the draws of the checked steps."""
        trainer = self.reference()
        gen = inputs.device_gen(self.seed, "train", self.device)
        n = len(self.checked["losses"])
        losses, draws = [], []
        for i in range(n):
            state = gen.get_state()
            draws.append(trainer.scene.draws(gen, self.B))
            gen.set_state(state)
            out = trainer.step(gen, self.B)
            losses.append(out["loss"])
            if i == 0:
                u1, g1 = out["updates"], out["grads"]
        change = {k: trainer.P[k] - self.theta0[k] for k in trainer.P}
        ck = self.checked
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(ck["losses"],
                                                           losses))
        gnorm = {k: float(v.norm()) for k, v in g1.items()}
        med_g = float(np.median(list(gnorm.values())))
        kept = [k for k in gnorm if gnorm[k] >= 1e-3 * med_g]
        grad = leaf_gaps(ck["u1"], u1, list(u1))
        moved = leaf_gaps(ck["change"], change, kept)
        diff = sum(float((ck["u1"][k] - u1[k]).double().norm()) ** 2
                   for k in u1)
        whole = sum(float(u1[k].double().norm()) ** 2 for k in u1)
        return {"values": {
                    "loss_gap": loss_gap,
                    "grad_gap": max(grad), "change_gap": max(moved),
                    "grad_diff": (diff / whole) ** 0.5,
                    "grad_gap_median": float(np.median(grad)),
                    "grad_gap_q25": float(np.quantile(grad, 0.25)),
                    "change_gap_median": float(np.median(moved))},
                "failed_checked": ck["skipped"],
                "leaves": {k: [float(ck["u1"][k].norm()), float(u1[k].norm()),
                               float((ck["u1"][k] - u1[k]).norm()),
                               float(ck["change"][k].norm()),
                               float(change[k].norm()),
                               float((ck["change"][k] - change[k]).norm()),
                               gnorm[k]] for k in u1},
                "draws": [[t.cpu() for t in d] for d in draws],
                "left_out": sorted(set(gnorm) - set(kept))}

    def shapes(self, draws: list) -> dict:
        """Per-launch shapes of the kernels the window drives, for the
        roofline readers: the CC over the batch, and (anechoic bfloat16
        mix) the windows, frames, Toeplitz tile width, distinct
        measurements and pool bytes of the checked steps' draws (mean)."""
        fs = self.cfg["fs"]
        K = (len(ref_synth.lag_interp(fs, fs, self.cfg["n_bands"])[0]) - 1) // 2
        out = {"cc_lags": {"rows": self.B, "n": fs, "max_kept": K}}
        x = self.inp
        if (x["scene"] == "anechoic"
                and self.config["policy"]["mix_dtype"] == "bfloat16"):
            L = x["ir"].shape[-1]
            kb_cols = 128 * (-(-(128 + L - 1) // 128))
            nblk = -(-max(L - 1 + fs, 2 * (L - 1) + bounds.WIN) // 128) + 1
            nq = (int(self.traffic["segment_samples"]) - fs) // 128 + 1
            meas, pool = [], []
            for _, _, m, seg, q, crop in draws:
                meas.append(len(np.unique(m.numpy())))
                pool.append(bounds.window_bytes((seg * nq + q).numpy().ravel(),
                                                crop.numpy().ravel(),
                                                nblk * 128))
            out["gather_mix_kb"] = {
                "windows": self.B * 3, "frames": fs // 128,
                "kb_cols": kb_cols, "distinct_meas": float(np.mean(meas)),
                "pool_bytes": float(np.mean(pool))}
        return out


def leaf_gaps(prog: dict, ref: dict, names: list) -> list:
    """Per leaf of `names`: |norm(prog) - norm(ref)| / max(norm(ref), the
    median leaf's reference norm)."""
    rn = {k: float(ref[k].double().norm()) for k in ref}
    med = float(np.median(list(rn.values())))
    return [abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
            for k in names]
