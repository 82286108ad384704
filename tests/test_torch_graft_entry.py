"""omnidata_tpu_torch.graft_entry, the port's counterpart of the root
``__graft_entry__.py`` (tests/test_graft_entry.py:10,20, both ``slow``
there): ``dryrun_multichip`` at 1, 2 and 4 ranks, asked for the CPU (its
own gloo group; 4 ranks are 2x2, data and the ViT's Megatron splits),
prints JAX's two OK lines, and on the card, its default, raises without
one; ``entry()`` gives the DPT-hybrid-384 normals forward at its
published widths, 384²."""
import re

import numpy as np
import pytest
import torch

from omnidata_tpu_torch import graft_entry

torch.set_num_threads(1)


@pytest.mark.parametrize("n,grid", [(1, (1, 1)), (2, (2, 1)), (4, (2, 2))])
def test_dryrun_multichip(capsys, n, grid):
    graft_entry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    m = re.search(r"dryrun_multichip OK: mesh=\{'data': (\d+), 'model': (\d+)\} "
                  r"batch=(\d+) loss=(\S+)", out)
    assert m, out
    assert (int(m[1]), int(m[2])) == grid and int(m[3]) == grid[0]
    assert np.isfinite(float(m[4]))
    m = re.search(rf"dryrun_multichip annotate OK: {n}-way sharded render, (\d+) valid px", out)
    assert m and int(m[1]) > 0, out


def test_dryrun_multichip_steps_every_grid_alike(capsys):
    """The same seeded weights and batch rows give one global loss at any
    grid (the 4-rank run prints the 1-rank run's loss)."""
    losses = []
    for n in (1, 4):
        graft_entry.dryrun_multichip(n, device="cpu")
        losses.append(float(re.search(r"loss=(\S+)", capsys.readouterr().out)[1]))
    assert losses[0] == losses[1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_runs_on_the_card_or_raises(n):
    """The card is the default: without one it raises, as every entry
    point of the port does, and never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(n)


def test_entry_is_the_published_dpt_normals_forward():
    fn, (net, x) = graft_entry.entry(device="cpu")
    assert tuple(x.shape) == (1, 3, 384, 384)
    assert net.vit_dim == 768 and len(net.pretrained.model.blocks) == 12
    y = fn(net, x)
    assert tuple(y.shape) == (1, 3, 384, 384) and bool(torch.isfinite(y).all())
