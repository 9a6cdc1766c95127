"""The work counts: the FLOP count of a tiny AGM-Net block against a hand
count, and attention's least time against the port's own reckoning
(``chip_smoke.attention_bounds``) on its three shapes."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from igs_bench import flops
from igs_bench.reference.models.swin import (
    TransformerLayer, shift_window_region_ids)
from igs_bench.reference.ops.attention import region_pairs


def test_flops_of_one_swin_layer_match_a_hand_count():
    b, t, c = 2, 24, 16
    layer = TransformerLayer(d_model=c)
    x = torch.randn(b, t, c)
    with FlopCounterMode(display=False) as counter:
        layer(x, x, h=4, w=6, attn_num_splits=1)
    # q, k, v, merge: 4 (T·C)·C products; the FFN on [x, message]: 2C → 8C
    # → C; attention: q·kᵀ and p·v, T·T·C each; two FLOPs a product
    hand = 2 * b * (4 * t * c * c + t * (2 * c) * (8 * c)
                    + t * (8 * c) * c + 2 * t * t * c)
    assert counter.get_total_flops() == hand


@pytest.mark.parametrize("name,shape,shifted", [
    ("triplane", (5, 8, 8192, 64), False),
    ("swin shifted", (80, 4, 1024, 128), True),
    ("swin", (80, 4, 1024, 128), False)])
@pytest.mark.parametrize("esz", [2, 4])
def test_attention_work_matches_the_port_reckoning(name, shape, shifted, esz):
    import chip_smoke

    ids = None
    if shifted:
        ids = torch.from_numpy(shift_window_region_ids(64, 64, 32, 32, 16, 16))
    pairs = region_pairs(shape, ids)
    assert pairs == chip_smoke.attention_pairs(shape, ids)
    ours = flops.attention_bounds(shape, pairs, esz)
    theirs = chip_smoke.attention_bounds(shape, pairs, esz)
    assert np.isclose(1e3 * ours["fwd"], theirs["bound_ms"], rtol=1e-12)
    assert np.isclose(1e3 * ours["bwd"], theirs["bwd_bound_ms"], rtol=1e-12)
    assert ours["fwd_by"] == theirs["bound_by"]
