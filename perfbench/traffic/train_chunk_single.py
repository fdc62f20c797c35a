"""Traffic driver: ``train_chunk``'s closed-loop fused training for the
single-controller model (``perfbench/configs/biear-single.json``).

The program runs as in ``train_chunk.Cell``: the same synthesizer,
``models.build_active`` (``controller_mode`` "single" builds the shared
controller), ``train.loop.make_train_chunk`` and its captured chunk,
the optimizer, window, traced window, stages and check. Only what names
the plain reference changes: the weights come from
``reference/single.py``'s parameter list, the step's FLOPs from its
loss, and the checked steps are repeated by its trainer.
"""

from __future__ import annotations

import torch

from perfbench import bounds, inputs
from perfbench.reference import model as ref_model
from perfbench.reference import single
from perfbench.traffic import train_chunk


class Cell(train_chunk.Cell):

    def weights(self) -> dict:
        return ref_model.make_params(
            single.param_specs(self.cfg),
            inputs.device_gen(self.seed, "weights", self.device))

    def flops_per_utt(self) -> float:
        """The products of one forward and backward of the reference
        single-controller model on FLOP_ROWS rows on the CPU."""
        cfg, cpu, rows = self.cfg, torch.device("cpu"), train_chunk.FLOP_ROWS
        P = {k: v.detach().to(cpu).requires_grad_(True)
             for k, v in self.theta0.items()}
        c = ref_model.constants(cfg, cpu)
        g = torch.Generator().manual_seed(0)
        wav = torch.rand((2, rows, cfg["fs"]), generator=g) * 2 - 1
        x3 = torch.rand((rows, cfg["n_bands"]), generator=g)
        y = torch.zeros((rows, ref_model.N_SECTORS * 7))
        hp = self.config["train"]
        return bounds.train_flops_per_utt(
            lambda: (single.loss(cfg, hp, c, P, (wav[0], wav[1], x3, y), g),
                     list(P.values())), rows)

    def reference(self):
        scene = super().reference().scene
        return single.Trainer(self.cfg, self.config["train"], self.theta0,
                              scene, self.device)
