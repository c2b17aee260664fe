"""A bf16 ViT-SOM past 320 keys against the JAX package, on the CPU.

``vit.patch_size`` 1 on a 20x20 input gives N 401 tokens (the flagship's
widths otherwise: emb 16 and 2 heads, hd 8; the decoder's emb 4, hd 2),
past the 320 keys that the one-pass bf16 forwards hold in registers, so
on the card ``train.attn_impl: pallas`` runs the two-pass forwards and the
backward at that N. Here the port runs the kernels' plain bf16 versions and
the JAX package its Pallas kernels in interpret mode, one train step from
shared weights on one batch (depth 1, decoder depth 1, a 4x4 map, batch
2), at ``tests/test_torch_bf16.py``'s bf16 train-step bounds: losses at
rtol 2e-3, the gradients elementwise at the JAX tests' bf16 gradient bound
(atol 2e-1, rtol 1e-1) and within 1e-1 of JAX's in relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.config import load_config as jload
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu.train import optim as joptim
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.models.vit_som import ViTSOM as TViTSOM
from vitsom_tpu_torch.ops import attention_fused as tfused
from vitsom_tpu_torch.train import optim as toptim
from vitsom_tpu_torch.train import schedules as tsched
from vitsom_tpu_torch.train import steps as tsteps
from test_torch_train import _capture_grads

FLAGSHIP = "configs/vit_som/vit_som_mnist.yaml"
LONG = {"data.input_size": 20, "vit.patch_size": 1, "vit.depth": 1, "vit.dec_depth": 1,
        "som.map_size": [4, 4], "batch_size": 2, "total_epochs": 2,
        "train.remat_blocks": False, "train.compute_dtype": "bfloat16",
        "train.attn_impl": "pallas"}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and torch's default of one thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_long_sequence_config_runs_the_two_pass_forwards():
    """N 401 at the encoder's hd 8 and the decoder's hd 2: both take the
    two-pass mma.sync forward and the mma.sync backward on the card."""
    cfg = jload(FLAGSHIP, LONG)
    n = (cfg.data.input_size // cfg.vit.patch_size) ** 2 + 1
    assert n == 401
    for emb in (cfg.vit.emb_dim, cfg.vit.dec_emb_dim):
        hd = emb // cfg.vit.heads
        assert tfused.bf16_kernel(n, hd) == "attn_fwd_hmma2_bf16"
        assert tfused.bf16_kernel(n, hd, backward=True) == "attn_bwd_hmma_bf16"


def test_bf16_vit_som_past_320_keys_matches_jax():
    """One bf16 ``pallas`` train step at N 401 from shared weights against
    ``make_vit_som_train_step``: the three losses at rtol 2e-3, the
    schedule values at rtol 1e-6, every gradient at atol 2e-1 / rtol 1e-1
    and all of them within 1e-1 of JAX's in relative L2."""
    jcfg = jload(FLAGSHIP, LONG)
    tcfg = tconfig.config_from_dict(jcfg.to_dict())
    jmodel = JViTSOM(jcfg, attn_impl="pallas")
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((2, 20, 20, 1)))["params"]
    tmodel = TViTSOM(tcfg, attn_impl="pallas")
    tmodel.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    x = np.random.default_rng(3).uniform(size=(2, 20, 20, 1)).astype(np.float32)

    statics = jsteps.StepStatics(3, 2, 6, 2)
    base_lr = joptim.base_learning_rate(jcfg)
    jsch = jsched.make_lr_schedule(jcfg.optimizer, 2, 3, base_lr)
    tx = _capture_grads(joptim.make_optimizer(jcfg, params, jsch))
    jstep = jax.jit(jsteps.make_vit_som_train_step(jcfg, jmodel, tx, statics, jsch))
    state = jsteps.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                              opt_state=tx.init(params))
    state, jm = jstep(state, {"image": jnp.asarray(x), "label": jnp.zeros((2,), jnp.int32)})

    opt = toptim.make_optimizer(tcfg, tmodel)
    tstep = tsteps.make_vit_som_train_step(
        tcfg, tmodel, opt, tsteps.StepStatics(3, 2, 6, 2),
        tsched.make_lr_schedule_tensor(tcfg.optimizer, 2, 3, base_lr),
        tsteps.DeviceState("cpu", 3))
    tm = tsteps.metrics_dict(tstep({"image": torch.from_numpy(x)}))
    for k in ("train/recon_loss", "train/som_loss", "train/total_loss"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=2e-3, err_msg=k)
    for k in ("hp/gamma", "hp/temperature", "hp/lr"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-6, err_msg=k)

    named = dict(tmodel.named_parameters())
    g_j = convert.flax_to_state_dict(jax.device_get(state.opt_state[1]))
    g_t = {n: named[n].grad for n in g_j}
    for n in g_j:
        np.testing.assert_allclose(g_t[n].numpy(), g_j[n].numpy(), atol=2e-1, rtol=1e-1,
                                   err_msg=n)
    num = sum(float(((g_t[n] - g_j[n]) ** 2).sum()) for n in g_j)
    assert (num / sum(float((g_j[n] ** 2).sum()) for n in g_j)) ** 0.5 <= 1e-1
