"""One train step of each model family and input path on a 2x2 mesh of gloo
ranks (CPU processes, tests/_torch_parallel_worker.py): the counterpart of
``__graft_entry__.dryrun_multichip``.

The arms: the active model on a dataset batch with a padded tail, on an
anechoic and on a reverberant (spirit) synthesised batch (each rank makes
its rows of the global batch), the passive model on its 6-field batch,
AuralNet, and the active model on rows read from a ``.shard`` file. Each
step's loss must be finite, the same on every rank and equal to the
world-of-one step's on the whole batch to rtol 2e-4 (tests/test_sharding.py's
mesh tolerance), dropout 0.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parallel_worker import _synth, launch
from test_torch_parallel_steps import ATTN, SMALL, _batches

from biear_tpu_torch.data.shard import ShardDataset, shard_shapes, write_shard
from biear_tpu_torch.models import (ActiveBiEAR, AuralNet, BiEARConfig,
                                    PassiveBiEAR)
from biear_tpu_torch.train.loop import make_train_step
from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

B, LOSS_RTOL = 8, 2e-4
CLASSES = {"active": ActiveBiEAR, "passive": PassiveBiEAR,
           "auralnet": AuralNet}
ARMS = {"active-dataset": ("active", "arrays"),
        "anechoic-synth": ("active", "anechoic"),
        "reverb-synth": ("active", "spirit"),
        "passive": ("passive", "arrays"),
        "auralnet": ("auralnet", "arrays"),
        "shard-input": ("active", "shard")}


def _whole_batch(arm):
    if arm["input"] == "shard":
        ds = ShardDataset(arm["path"], shapes=arm["shapes"])
        return tuple(torch.as_tensor(a) for a in ds.rows(np.arange(B)))
    if arm["input"] == "arrays":
        data = np.load(arm["path"])
        return tuple(torch.as_tensor(data[f"a{j}"])
                     for j in range(int(data["n"])))
    return _synth(arm).sample_batch(torch.Generator().manual_seed(3), B)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel-dryrun")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    arms, want = [], {}
    try:
        for name, (family, source) in ARMS.items():
            kw = dict(SMALL, **ATTN) if family == "auralnet" else SMALL
            cfg = BiEARConfig(**kw)
            model = CLASSES[family](cfg).init_weights_(1)
            weights = tmp / f"{family}.pt"
            torch.save(model.state_dict(), weights)
            arm = dict(name=name, family=family, cfg=kw, input=source,
                       weights=str(weights), batch_size=B)
            if source == "arrays":
                arrays = _batches(family, seed=2)[1]    # a padded tail
                np.savez(tmp / f"{name}.npz", n=len(arrays),
                         **{f"a{j}": a for j, a in enumerate(arrays)})
                arm["path"] = str(tmp / f"{name}.npz")
            elif source == "shard":
                arm["path"] = str(tmp / "rows.shard")
                write_shard(arm["path"], _batches(family, seed=3)[0][:4])
                arm["shapes"] = shard_shapes(cfg, False)
            hp = TrainHyper()
            step = make_train_step(model, hp, make_optimizer(model, hp))
            want[name] = float(step(_whole_batch(arm),
                                    torch.Generator().manual_seed(0))["loss"])
            arms.append(arm)
    finally:
        torch.set_num_threads(threads)
    launch(4, "dryrun", {"arms": arms, "mesh": [2, 2], "out": str(tmp)})
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(4)]
    return ranks, want


@pytest.mark.parametrize("name", list(ARMS))
def test_one_step_on_2x2_equals_the_world_of_one(dryrun, name):
    ranks, want = dryrun
    got = [r[name] for r in ranks]
    assert all(g == got[0] for g in got)
    assert np.isfinite(got[0])
    np.testing.assert_allclose(got[0], want[name], rtol=LOSS_RTOL)
