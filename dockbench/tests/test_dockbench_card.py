"""On the card only: the CNN's control (the reference's ensemble with TF32
on) reads a gap above the cell's limit on poses where the reference in
float32 agrees with itself.  Skips without a card; run on the chip with
`python -m pytest dockbench/tests/test_dockbench_card.py -q`."""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tf32_control_exceeds_the_cnn_limits(card):
    import torch

    from dockbench import gen, lookup
    from dockbench.reference import check, chem, cnn

    t = lookup.traffic("screen_druglike")
    t.update(ligands_per_call=2, rounds_in_pool=1)
    screen = gen.Screen(t, os.path.join(ROOT, "dockbench", ".cache"))
    rec = check.Receptor(screen.receptor_pdb())
    _, ligs, _ = screen.call(5, 1)
    lig, x = ligs[0]
    g = check.given(chem.parse_sdf(gen.sdf_text([(lig, x)]))[0])
    rng = np.random.default_rng(0)
    poses = np.stack([x - x.mean(0) + screen.center + rng.normal(size=3)
                      for _ in range(16)])
    cfg = lookup.config(lookup.benchmark(), "gnina_default")
    models = cnn.load_models(cfg["cnn_models"], os.path.join(
        ROOT, cfg["models_dir"]), card)
    limits = lookup.limits("gnina_default.screen")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s32, a32 = cnn.score(models, rec.xyz, rec.types, poses, g.types, card)
    s32b, a32b = cnn.score(models, rec.xyz, rec.types, poses, g.types, card)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        stf, atf = cnn.score(models, rec.xyz, rec.types, poses, g.types, card)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    assert np.abs(s32b - s32).max() < limits["cnnscore_gap"]
    assert np.abs(a32b - a32).max() < limits["cnnaffinity_gap"]
    print(json.dumps(dict(score=float(np.abs(stf - s32).max()),
                          affinity=float(np.abs(atf - a32).max()))))
    assert np.abs(stf - s32).max() > limits["cnnscore_gap"] \
        or np.abs(atf - a32).max() > limits["cnnaffinity_gap"]
