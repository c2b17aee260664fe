"""The prototype decode's conditioning measurement
(``vitsom_tpu_torch/eval/decode_conditioning.py``) on the CPU, at
``vit_som_mnist.yaml``'s decoder with a 4x4 map."""

import pytest

from vitsom_tpu_torch.eval import decode_conditioning as dc

CONFIG = "configs/vit_som/vit_som_mnist.yaml"


@pytest.fixture(scope="module")
def measured():
    return dc.measure(CONFIG, device="cpu", seed=0, overrides={"som.map_size": [4, 4]})


def test_every_op_is_measured(measured):
    for name in (*dc.OPS, "all"):
        r = measured[name]
        assert r["max_ulp_injected"] > 0
        assert r["amplification"] == r["max_abs_delta"] / r["max_ulp_injected"]


def test_perturbed_pixels_move_by_one_ulp(measured):
    """A float32 ulp added to the float32 pixels moves them by exactly the
    largest ulp added: the measurement's own floor."""
    assert measured["unpatchify"]["amplification"] == 1.0
    assert measured["unpatchify"]["delta_in_pixel_ulps"] <= 1.0


def test_zero_cls_row_meets_layernorm_at_its_largest_gain(measured):
    """The decode prepends a zero CLS token: its first LayerNorm row has no
    variance, so the norm divides it by sqrt(eps) (a gain of 1000 at eps
    1e-6), far past any patch row's."""
    gain = measured["layernorm_max_gain"]
    assert gain["cls"] == pytest.approx(1e3)
    assert gain["patches"] < gain["cls"]
