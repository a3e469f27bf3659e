"""The Mask2Former segmentation objective through the whole toy segmenter
(``test_torch_port_seg_train.py``'s: d 32, 4 layers, 64 px, 8 queries, 2
decoder rounds, 1 pixel-decoder layer, 32 points) against
``jax.value_and_grad`` of the JAX criterion on the same weights, with JAX's
random draws injected: the loss and its metrics at 1e-5, all the gradients
together at 1e-4 and each parameter's at 1e-3 (relative L2, over a floor
of 1e-6 of the whole for the gradients that are 0 but for rounding), the port's
trunk under remat (the JAX trunk has none).  A file of its own: its one
JAX compile takes most of a minute on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.criterions.vision_criterions import SegmentationCriterion as JaxCriterion
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_port_seg_train import (MAX_INSTANCES, M2F_KW, NUM_POINTS, _criterion_cfg, _np,
                                       inject, jax_draws, seg_batch, segmenters)


def test_mask2former_segmenter_loss_and_gradients_match_jax(monkeypatch):
    jseg, tree, tseg = segmenters("mask2former")
    cfg = _criterion_cfg()
    batch = seg_batch(14)
    rng = jax.random.PRNGKey(15)

    def jfn(p):
        return JaxCriterion(cfg)(jseg, p, jax.tree.map(jnp.asarray, batch), rng)

    (want, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    inject(monkeypatch, jax_draws(rng, M2F_KW["dec_layers"] + 1, 2, MAX_INSTANCES, NUM_POINTS))
    tseg.backbone.cfg.checkpoint_activations = True
    tseg.zero_grad(set_to_none=True)
    try:
        got, m = build_criterion(cfg)(tseg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      generator=torch.Generator().manual_seed(0))
        got.backward()
    finally:
        tseg.backbone.cfg.checkpoint_activations = False
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(m) == set(jm)
    for key in jm:
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    ref = params_from_jax(_np(jg))
    names = [name for name, _ in tseg.named_parameters()]
    assert set(names) == set(ref)
    wants = [ref[name].double().flatten() for name in names]
    grads = [torch.zeros_like(w) if tseg.get_parameter(n).grad is None
             else tseg.get_parameter(n).grad.double().flatten() for n, w in zip(names, wants)]
    g, w = torch.cat(grads), torch.cat(wants)
    assert (g - w).norm() <= 1e-4 * w.norm()
    # a gradient that is 0 but for rounding (the LayerNorm biases in front of
    # a per-channel GroupNorm) is held to a floor of 1e-6 of the whole
    for name, gi, wi in zip(names, grads, wants):
        assert (gi - wi).norm() <= 1e-3 * wi.norm() + 1e-6 * w.norm(), name
    assert tseg.get_parameter("backbone.image_adapter.rel_pos_table").grad.abs().sum() > 0
