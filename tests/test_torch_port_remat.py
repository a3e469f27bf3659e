"""The ``qkv`` and ``offload_qkv`` remat policies of the port's encoder
(``one_peace_tpu/models/encoder.py``'s ``save_only_these_names("qkv")`` and
``save_and_offload_only_these_names``): the same loss and gradients as
``full``, bit for bit, with three GEMMs fewer per layer in the backward
(the q/k/v projections are not replayed), and the attention replayed.
On the CPU the offloaded projections are already on the host: no pinned
memory is needed."""

import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)
from torch.utils._python_dispatch import TorchDispatchMode

from helpers import tiny_model_config
from one_peace_tpu_torch.models import components
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.ops import flash_attention as fa
from one_peace_tpu_torch.utils.random_weights import fill_random_

LAYERS = 3
POLICIES = ("full", "qkv", "offload_qkv")
STOCHASTIC = dict(drop_path_rate=0.1, dropout=0.1, activation_dropout=0.1)


def _model(policy: str, dtype=torch.float32):
    cfg = tiny_model_config(head_type="vl")
    cfg.encoder.layers = LAYERS
    cfg.encoder.checkpoint_activations = True
    cfg.encoder.remat_policy = policy
    for k, v in STOCHASTIC.items():
        setattr(cfg.encoder, k, v)
    model = fill_random_(OnePeaceRetrievalModel(cfg, device="cpu"),
                         torch.Generator().manual_seed(0)).to(dtype)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def _batch(dtype=torch.float32):
    rs = np.random.RandomState(0)
    tokens = torch.as_tensor(rs.randint(5, 99, (4, 7)))
    tokens[2, 4:] = 1
    return tokens, torch.as_tensor(rs.randn(4, 3, 32, 32).astype(np.float32)).to(dtype)


class _CountGemms(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in components._GEMM_OPS
        return func(*args, **(kwargs or {}))


def _run(policy: str, dtype=torch.float32, encoder_type="vl"):
    """(loss, gradients, GEMMs in the backward, attention forwards in the
    backward) of one stochastic step with remat under ``policy``."""
    model = _model(policy, dtype)
    tokens, images = _batch(dtype)
    text, image = model.encoder_wrapper(
        src_tokens=tokens, src_images=images, encoder_type=encoder_type,
        deterministic=False, generator=torch.Generator().manual_seed(7))[:2]
    loss = text.float().square().mean()
    if image is not None:
        loss = loss + image.float().sin().mean()
    params = [p for _, p in model.named_parameters()]
    calls = []
    plain = fa.flash_attention_plain

    def spy(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    fa.flash_attention_plain = spy
    try:
        with _CountGemms() as count:
            grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        fa.flash_attention_plain = plain
    return loss.detach(), grads, count.count, len(calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy", ["qkv", "offload_qkv"])
def test_losses_and_gradients_equal_full(policy, dtype):
    loss_full, grads_full, _, _ = _run("full", dtype)
    loss, grads, _, _ = _run(policy, dtype)
    torch.testing.assert_close(loss, loss_full, rtol=0, atol=0)
    assert sum(g is not None for g in grads) > 0
    for a, b in zip(grads, grads_full):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["qkv", "offload_qkv"])
def test_three_fewer_gemms_per_layer_and_attention_replayed(policy):
    """The backward of ``full`` replays every GEMM of each layer; under the
    qkv policies it replays all but the three q/k/v projections.  The
    attention's forward is replayed in every policy (once per layer): its
    output and statistics come from the replay."""
    _, _, gemms_full, attn_full = _run("full", encoder_type="text")
    _, _, gemms, attn = _run(policy, encoder_type="text")
    assert gemms_full - gemms == 3 * LAYERS
    assert attn == attn_full == LAYERS


def test_offload_needs_no_pinned_memory_on_the_cpu(monkeypatch):
    """A CPU projection is kept as it is: ``offload_qkv`` never asks for
    pinned memory on the host (no card is needed for it)."""
    real_empty = torch.empty

    def no_pinning(*args, **kwargs):
        assert not kwargs.get("pin_memory", False), "pinned memory asked for on the CPU"
        return real_empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_pinning)
    loss, grads, _, _ = _run("offload_qkv")
    assert torch.isfinite(loss) and all(g is None or torch.isfinite(g).all() for g in grads)


def test_projection_store_checks_versions():
    """The store gives a kept projection back to the asking device, and
    raises when the alias it kept was modified in place before the
    replay."""
    kept = components._ProjectionStore(offload=False)
    x = torch.randn(3, 4)
    kept.put(x)
    torch.testing.assert_close(kept.take(x.device), x, rtol=0, atol=0)
    kept.taken = 0
    x.add_(1.0)
    with pytest.raises(RuntimeError, match="modified in place"):
        kept.take(x.device)


def test_policies_are_no_ops_without_a_gradient():
    """Under no_grad nothing is checkpointed: every policy gives the same
    forward."""
    outs = []
    for policy in POLICIES:
        model = _model(policy)
        tokens, images = _batch()
        with torch.no_grad():
            outs.append(model.encoder_wrapper(src_tokens=tokens, src_images=images,
                                              encoder_type="vl")[0])
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
