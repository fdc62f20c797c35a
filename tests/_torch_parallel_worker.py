"""Worker processes of the port's multi-process tests
(tests/test_torch_parallel_*.py), and the launcher the tests call.

    python tests/_torch_parallel_worker.py <task> <spec.json>

``launch(n, task, spec)`` starts n such processes with torchrun's
variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT on a
free port), one torch thread each, and waits for all of them; a process
that fails or hangs fails the test with every rank's output. Each worker
joins a gloo process group on the CPU (``parallel.mesh.init_distributed``)
and runs one task:

  * ``steps``: for each case, a model (weights from a file), cut over a
    data x model mesh, takes train steps on its rows of the given global
    batches; each rank writes its losses, skip flags and gradient norms
    per step and the last step's histograms, rank 0 also the whole
    parameters. A case may poison one parameter's gradient on one
    rank at one step (``poison``).
  * ``dropout``: the body and heads in training mode with dropout on, each
    rank under its ``runner.dropout_streams``; each rank writes the
    outputs and its shared generator's state.
  * ``runner``: ``train.runner.train`` of a run config (written by the
    test as JSON), with a tripwire on every rank but 0 that fails any write
    under the runs root; prints ``RESULT <json>``.
  * ``dryrun``: one train step of each model family and input path (the
    counterpart of ``__graft_entry__.dryrun_multichip``); each rank writes
    its losses.
  * ``capture``: the captured mesh programs on the CPU, the CUDA calls of
    the capture machinery replaced by tests/_torch_graph_stand_in.py and
    the model taken to be on a card, so the entry points choose their
    captured path by the real rule (``graph.use_capture``): under 2x1,
    the two-graph chunk and step against the eager ones, the eval step
    and chunk, steps on the spec's batches, the split flat all-reduce
    against the one-call reduction; under 1x2 what each entry point does with
    ``capture=True`` and by default. Each rank saves its results.

The workers import no JAX.
"""

import faulthandler
import json
import os
import socket
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
HANG_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, task: str, spec: dict, timeout: float = HANG_S + 30):
    """Run `task` on n ranks; returns each rank's standard output."""
    port = free_port()
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(spec, f)
    procs = []
    try:
        for r in range(n):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("JAX", "XLA"))}
            env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, task, f.name], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True))
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                outs.append("<timed out>")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        os.unlink(f.name)
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"{task}: exit codes {codes}\n" + "\n".join(
            f"--- rank {r} ---\n{o[-6000:]}" for r, o in enumerate(outs)))
    return outs


# ---------------- the tasks ----------------

def _model(family: str, cfg_kw: dict, weights: str):
    import torch
    from biear_tpu_torch.models import (ActiveBiEAR, AuralNet, BiEARConfig,
                                        PassiveBiEAR)
    cls = {"active": ActiveBiEAR, "passive": PassiveBiEAR,
           "auralnet": AuralNet}[family]
    model = cls(BiEARConfig(**cfg_kw))
    model.load_state_dict(torch.load(weights, weights_only=True),
                          strict=True)
    return model


def task_steps(spec: dict, rank: int) -> None:
    import numpy as np
    import torch
    from biear_tpu_torch.parallel.mesh import Mesh, full_state_dict, shard_model
    from biear_tpu_torch.train.loop import make_train_step
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    for case in spec["cases"]:
        model = _model(case["family"], case["cfg"], case["weights"])
        mesh = Mesh(*case["mesh"], "cpu")
        mesh.broadcast_module_(model)
        shard_model(model, mesh)
        hp = TrainHyper()
        opt = make_optimizer(model, hp)
        step = make_train_step(model, hp, opt, mesh=mesh)
        data = np.load(case["batches"])
        poison = case.get("poison")
        losses, skipped, norms = [], [], []
        for i in range(case["steps"]):
            arrays = [data[f"b{i}_{j}"] for j in range(int(data["n"]))]
            a, z = mesh.rows(len(arrays[0]))
            batch = tuple(torch.as_tensor(x[a:z]) for x in arrays)
            hook = None
            if poison and poison["rank"] == rank and poison["step"] == i:
                p = dict(model.named_parameters())[poison["param"]]
                hook = p.register_hook(lambda g: g * float("inf"))
            m = step(batch, torch.Generator().manual_seed(i))
            if hook is not None:
                hook.remove()
            losses.append(float(m["loss"]))
            skipped.append(float(m["skipped"]))
            norms.append([float(m["grad_fb_norm"]),
                          float(m["grad_backend_norm"])])
        full = full_state_dict(model)
        out = os.path.join(spec["out"], case["name"])
        with open(f"{out}.rank{rank}.json", "w") as f:
            json.dump({"losses": losses, "skipped": skipped,
                       "norms": norms,
                       "grad_hist": m["grad_hist"].tolist()}, f)
        if rank == 0:
            torch.save(full, f"{out}.pt")


def task_dropout(spec: dict, rank: int) -> None:
    import numpy as np
    import torch
    from biear_tpu_torch.parallel.mesh import Mesh, shard_model
    from biear_tpu_torch.train.runner import dropout_streams, keyed_generator

    model = _model("active", spec["cfg"], spec["weights"])
    mesh = Mesh(*spec["mesh"], "cpu")
    shard_model(model, mesh)
    model.train()
    x = torch.as_tensor(np.load(spec["x"]))
    shared = keyed_generator("cpu", 5, 1, 0)
    gen = dropout_streams(mesh, shared, "cpu", 5, 1, 0) or shared
    body = model.body(x, gen, train=True)
    sound, aoa, dist = model.subheads(body, gen, train=True)
    torch.save({"body": body, "sound": sound, "aoa": aoa, "dist": dist,
                "shared_state": shared.get_state()},
               os.path.join(spec["out"], f"rank{rank}.pt"))


def _tripwire(runs_root: str, rank: int) -> None:
    """Fail any write or directory creation under runs_root."""
    import builtins
    real_open, real_makedirs = builtins.open, os.makedirs

    def guarded_open(file, mode="r", *a, **k):
        if (isinstance(file, (str, os.PathLike))
                and str(file).startswith(runs_root)
                and any(c in str(mode) for c in "wxa+")):
            raise AssertionError(f"rank {rank} wrote {file} mode={mode}")
        return real_open(file, mode, *a, **k)

    def guarded_makedirs(name, *a, **k):
        if str(name).startswith(runs_root):
            raise AssertionError(f"rank {rank} made {name}")
        return real_makedirs(name, *a, **k)

    builtins.open = guarded_open
    os.makedirs = guarded_makedirs


def run_config(spec: dict):
    """The run config of a `runner` spec: a YAML of conf/ with the spec's
    fields and raw keys over it, at the spec's model geometry."""
    from biear_tpu_torch import config as tcfg
    from biear_tpu_torch.models import BiEARConfig
    rc = tcfg.load_run_config(os.path.join(REPO, "conf", spec["conf"]))
    for k, v in spec.get("fields", {}).items():
        setattr(rc, k, v)
    rc.raw = dict(rc.raw, **spec.get("raw", {}))
    rc.model_cfg = BiEARConfig(**spec["cfg"],
                               fixed_frontend_q=rc.fixed_frontend_q)
    return rc


def task_runner(spec: dict, rank: int) -> None:
    from biear_tpu_torch import train_biear
    from biear_tpu_torch.train.runner import train

    sys.modules["torch.utils.tensorboard"] = None
    rc = run_config(spec)
    if rank != 0:
        _tripwire(os.path.abspath(rc.runs_root), rank)
    synth = train_biear.make_synth(rc, "cpu") if rc.synth_on_device else None
    out = train(rc, synth=synth, quiet=True, seed=0, device="cpu",
                run_id=spec.get("run_id"),
                resume_from=spec.get("resume_from"))
    strip = lambda h: [{k: v for k, v in e.items() if k != "sec"} for e in h]
    print("RESULT " + json.dumps(
        {"train": strip(out["history"]["train"]),
         "val": strip(out["history"]["val"]), "test": strip([out["test"]]),
         "best": list(out["best_tuple"]), "run_dir": out["run_dir"],
         "global_step": out["global_step"]}, sort_keys=True))


def task_dryrun(spec: dict, rank: int) -> None:
    import numpy as np
    import torch
    from biear_tpu_torch.data.shard import ShardDataset
    from biear_tpu_torch.parallel.mesh import Mesh, shard_model
    from biear_tpu_torch.train.loop import make_train_step
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    out = {}
    for arm in spec["arms"]:
        model = _model(arm["family"], arm["cfg"], arm["weights"])
        mesh = Mesh(*spec["mesh"], "cpu")
        shard_model(model, mesh)
        hp = TrainHyper()
        step = make_train_step(model, hp, make_optimizer(model, hp),
                               mesh=mesh)
        B = arm["batch_size"]
        rows = mesh.rows(B)
        if arm["input"] == "shard":
            ds = ShardDataset(arm["path"],
                              shapes=[tuple(x) for x in arm["shapes"]])
            batch = tuple(torch.as_tensor(a) for a in
                          ds.rows(np.arange(*rows)))
        elif arm["input"] == "arrays":
            data = np.load(arm["path"])
            batch = tuple(torch.as_tensor(data[f"a{j}"][slice(*rows)])
                          for j in range(int(data["n"])))
        else:
            synth = _synth(arm)
            batch = synth.sample_batch(torch.Generator().manual_seed(3), B,
                                       rows=rows)
        m = step(batch, torch.Generator().manual_seed(0))
        out[arm["name"]] = float(m["loss"])
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _synth(arm: dict):
    """The synthesizer of a dryrun arm: the anechoic or a reverberant
    scene over the built-in test banks, or its passive features."""
    from biear_tpu_torch.data.passive_synth import PassiveFeatureSynth
    from biear_tpu_torch.data.synth import build_synthesizer
    from biear_tpu_torch.data.synth import make_test_segments
    synth = build_synthesizer(arm["input"], None, make_test_segments(8),
                              arm["cfg"]["fs"],
                              num_lags=arm["cfg"]["n_bands"], device="cpu")
    if arm["family"] == "passive":
        synth = PassiveFeatureSynth(synth, data_dim=arm["cfg"]["n_bands"],
                                    timesteps=arm["cfg"]["timesteps"])
    return synth


def one_call_reduce(mesh, grads: list, weight, scalars: list):
    """The data group's weighted mean of gradients and scalars in one call,
    as the train step reduced before it split at the all-reduce: the
    reference of ``pack_grads`` -> ``Mesh.data_sum_`` -> ``unpack_grads``."""
    import torch
    import torch.distributed as dist
    w = weight.reshape(1).float()
    flat = torch.cat([*(g.reshape(-1) * w for g in grads), w,
                      torch.stack(scalars).float() * w])
    dist.all_reduce(flat, group=mesh.data_group)
    n = flat.numel() - 1 - len(scalars)
    W = flat[n]
    den = torch.clamp(W, min=1e-8)
    out, o = [], 0
    for g in grads:
        out.append((flat[o:o + g.numel()] / den).view_as(g))
        o += g.numel()
    return out, list(flat[n + 1:] / den), W


def _split_reduce_equals_one_call(mesh, rank: int) -> bool:
    """The split reduction, with and without a preallocated buffer,
    against ``one_call_reduce`` on seeded gradients (rank 1's weight 0)."""
    import torch
    from biear_tpu_torch.parallel.mesh import (flat_numel, pack_grads,
                                               unpack_grads)
    g = torch.Generator().manual_seed(rank)
    grads = [torch.randn(s, generator=g) for s in ((3, 5), (7,), (2, 2, 2))]
    scalars = list(torch.rand(4, generator=g))
    weight = torch.tensor(3.0 if rank == 0 else 0.0)
    want = one_call_reduce(mesh, grads, weight, scalars)
    buf = torch.empty(flat_numel(grads, len(scalars)))
    same = True
    for out in (None, buf):
        flat = mesh.data_sum_(pack_grads(grads, weight, scalars, out))
        got = unpack_grads(flat, grads, len(scalars))
        same &= (all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
                 and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
                 and torch.equal(got[2], want[2]))
    return bool(same)


def task_capture(spec: dict, rank: int) -> None:
    import numpy as np
    import torch
    import _torch_graph_stand_in
    from biear_tpu_torch import graph as cgraph
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.parallel.mesh import (Mesh, full_state_dict,
                                               shard_model)
    from biear_tpu_torch.train import graph as tgraph
    from biear_tpu_torch.train.loop import (make_eval_chunk, make_eval_step,
                                            make_train_chunk,
                                            make_train_step)
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.train.runner import dropout_streams, keyed_seed

    _torch_graph_stand_in.install(setattr)
    cgraph.on_card = lambda model: True
    hp = TrainHyper()
    mesh = Mesh(2, 1, "cpu")
    out = {"split_reduce_equal": _split_reduce_equals_one_call(mesh, rank)}

    # the two-graph chunk and step against the eager ones, dropout on
    ir, az, dist_m = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist_m, make_test_segments(8),
                                num_lags=16, mix_dtype="bfloat16",
                                device="cpu")
    B, rows = spec["batch"], mesh.rows(spec["batch"])
    fixed = synth.sample_batch(torch.Generator().manual_seed(3), B,
                               rows=rows)
    for path, capture in (("eager", False), ("captured", None)):
        model = _model("active", spec["cfg"], spec["weights"])
        opt = make_optimizer(model, hp)
        chunk = make_train_chunk(model, hp, opt, synth.batch_fn(B, rows=rows),
                                 spec["chunk_steps"], mesh=mesh,
                                 capture=capture)
        step = make_train_step(model, hp, opt, mesh=mesh, capture=capture)
        kinds = [isinstance(chunk, tgraph.CapturedMeshChunk),
                 isinstance(step, tgraph.CapturedMeshStep)]
        gen, drop, ms = torch.Generator(), None, []
        for c in range(2):
            gen.manual_seed(keyed_seed(0, 1, c))
            drop = dropout_streams(mesh, gen, "cpu", 0, 1, c, streams=drop)
            ms.append(chunk(gen, 1.0, drop))
        step_gen = torch.Generator().manual_seed(7)
        ms.append(step(fixed, dropout_streams(mesh, step_gen, "cpu", 7)
                       or step_gen, 0.5))
        out[path] = {"metrics": ms, "kinds": kinds,
                     "params": [p.detach().clone()
                                for p in model.parameters()],
                     "gen": gen.get_state()}
        # the eval step and chunk on the trained model
        evals = (make_eval_step(model, hp, mesh=mesh, capture=capture),
                 make_eval_chunk(model, hp, mesh=mesh, capture=capture))
        kinds += [f.__qualname__.endswith("captured") for f in evals]
        out[path]["eval_step"] = evals[0](fixed)
        out[path]["eval_chunk"] = evals[1](
            tuple(torch.stack([t, t.flip(0)]) for t in fixed))

    # steps on the spec's global batches, captured (dropout 0)
    model = _model("active", spec["jax_cfg"], spec["jax_weights"])
    step = make_train_step(model, hp, make_optimizer(model, hp), mesh=mesh)
    data = np.load(spec["batches"])
    gen = torch.Generator().manual_seed(0)
    steps = []
    for i in range(spec["steps"]):
        arrays = [data[f"b{i}_{j}"] for j in range(int(data["n"]))]
        a, z = mesh.rows(len(arrays[0]))
        m = step(tuple(torch.as_tensor(x[a:z]) for x in arrays), gen)
        steps.append({k: float(m[k]) for k in ("loss", "skipped",
                                                "grad_fb_norm",
                                                "grad_backend_norm")})
    out["jax_steps"] = {"captured": isinstance(step, tgraph.CapturedMeshStep),
                        "steps": steps, "params": full_state_dict(model)}

    # a model axis: capture=True raises, the default is eager
    mesh = Mesh(1, 2, "cpu")
    model = shard_model(_model("active", spec["cfg"], spec["weights"]), mesh)
    opt = make_optimizer(model, hp)
    entries = {
        "step": lambda c: make_train_step(model, hp, opt, mesh=mesh,
                                          capture=c),
        "chunk": lambda c: make_train_chunk(model, hp, opt,
                                            synth.batch_fn(B), 1, mesh=mesh,
                                            capture=c),
        "eval_step": lambda c: make_eval_step(model, hp, mesh=mesh,
                                              capture=c),
        "eval_chunk": lambda c: make_eval_chunk(model, hp, mesh=mesh,
                                                capture=c)}
    out["model_axis"] = {}
    for name, build in entries.items():
        try:
            build(True)
            raised = None
        except ValueError as e:
            raised = str(e)
        # the eager entry points return a local function; the captured
        # ones a Captured* object or a function of another name
        name_of = lambda f: getattr(f, "__qualname__", type(f).__name__)
        out["model_axis"][name] = {
            "raised": raised,
            "default_eager": name_of(build(None)) == name_of(build(False))}
    torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))


TASKS = {"steps": task_steps, "dropout": task_dropout,
         "runner": task_runner, "dryrun": task_dryrun,
         "capture": task_capture}


def main():
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    task, spec_path = sys.argv[1], sys.argv[2]
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    from biear_tpu_torch.parallel import mesh
    mesh.TIMEOUT_S = 120.0          # a hung collective fails in minutes
    mesh.init_distributed("cpu")
    try:
        TASKS[task](spec, int(os.environ["RANK"]))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
