"""The port's training path below the loss: dropout and drop path (their
statistics, scales and generators), the encoder's drop-path schedule and
LayerDrop, and remat (``checkpoint_activations``), which must give the
gradients of the plain run with the same masks."""

import math
import sys

import numpy as np
import pytest
import torch

from helpers import tiny_model_config
from one_peace_tpu_torch.models import encoder as enc
from one_peace_tpu_torch.models.components import (drop_path, dropout, generator_on,
                                                   split_generator)
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.utils.random_weights import fill_random_

N = 200_000


def _binomial_bound(n: int, p: float) -> float:
    """Six standard deviations of the kept fraction of n Bernoulli(p) draws."""
    return 6 * math.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    x = torch.full((4, N // 4), 2.0)
    y = dropout(x, rate, False, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < _binomial_bound(N, 1 - rate)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / (1 - rate)))


def test_dropout_identity_and_generators():
    x = torch.randn(8, 16, 32)
    assert dropout(x, 0.3, True, None) is x
    assert dropout(x, 0.0, False, None) is x
    with pytest.raises(ValueError):
        dropout(x, 0.3, False, None)
    a = dropout(x, 0.3, False, torch.Generator().manual_seed(5))
    b = dropout(x, 0.3, False, torch.Generator().manual_seed(5))
    c = dropout(x, 0.3, False, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert dropout(x.bfloat16(), 0.3, False, torch.Generator().manual_seed(5)).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_path_one_mask_per_row(rate):
    b = 20_000
    x = torch.full((b, 3, 4), 1.5)
    y = drop_path(x, rate, False, torch.Generator().manual_seed(1))
    rows = y.reshape(b, -1)
    kept = rows[:, 0] != 0
    # whole rows are kept or dropped together
    assert torch.equal(rows != 0, kept[:, None].expand_as(rows))
    assert abs(kept.float().mean().item() - (1 - rate)) < _binomial_bound(b, 1 - rate)
    scale = np.float32(1) / (np.float32(1) - np.float32(rate))
    torch.testing.assert_close(rows[kept], torch.full_like(rows[kept], 1.5 * float(scale)))


def test_drop_path_identity_and_generators():
    x = torch.randn(64, 5, 8)
    assert drop_path(x, 0.4, True, torch.Generator()) is x
    assert drop_path(x, 0.4, False, None) is x
    assert drop_path(x, 0.0, False, torch.Generator()) is x
    a = drop_path(x, 0.4, False, torch.Generator().manual_seed(3))
    b = drop_path(x, 0.4, False, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (drop_path(x, 1.0, False, torch.Generator()) == 0).all()


def test_split_generator_and_generator_on():
    gens = split_generator(torch.Generator().manual_seed(0), 3)
    again = split_generator(torch.Generator().manual_seed(0), 3)
    draws = [torch.rand(4, generator=g) for g in gens]
    assert [torch.equal(d, torch.rand(4, generator=g)) for d, g in zip(draws, again)] == \
        [True] * 3
    assert not torch.equal(draws[0], draws[1])
    assert split_generator(None, 2) == [None, None]
    assert generator_on(None, "cpu") is None
    assert generator_on(torch.Generator(), "cpu").device.type == "cpu"


def _model(**enc_kw):
    cfg = tiny_model_config(head_type="vl")
    cfg.encoder.layers = 3
    for k, v in enc_kw.items():
        setattr(cfg.encoder, k, v)
    model = fill_random_(OnePeaceRetrievalModel(cfg), torch.Generator().manual_seed(0))
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def _batch():
    rs = np.random.RandomState(0)
    tokens = torch.as_tensor(rs.randint(5, 99, (4, 7)))
    tokens[2, 4:] = 1
    return tokens, torch.as_tensor(rs.randn(4, 3, 32, 32).astype(np.float32))


def _grads(model, seed, encoder_type="vl"):
    tokens, images = _batch()
    text, image = model.encoder_wrapper(
        src_tokens=tokens, src_images=images, encoder_type=encoder_type,
        deterministic=False, generator=torch.Generator().manual_seed(seed))[:2]
    loss = text.square().mean() + image.sin().mean()
    params = [p for _, p in model.named_parameters()]
    return loss.detach(), torch.autograd.grad(loss, params, allow_unused=True)


STOCHASTIC = dict(drop_path_rate=0.1, dropout=0.1, activation_dropout=0.1)


def test_remat_gradients_equal_plain_gradients():
    """checkpoint_activations on and off, the same generator seed, drop path
    0.1, dropout 0.1 and activation dropout 0.1: the same loss and grads."""
    plain = _model(**STOCHASTIC)
    remat = _model(checkpoint_activations=True, **STOCHASTIC)
    loss_a, grads_a = _grads(plain, seed=11)
    loss_b, grads_b = _grads(remat, seed=11)
    torch.testing.assert_close(loss_a, loss_b, rtol=0, atol=0)
    for (name, _), a, b in zip(plain.named_parameters(), grads_a, grads_b):
        assert (a is None) == (b is None), name
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)
    # the masks really drew: another seed moves the loss
    assert not torch.equal(_grads(plain, seed=12)[0], loss_a)


def test_remat_recompute_sees_swapped_parameters():
    """Under torch.func.functional_call (the trainer's compute-dtype copies)
    the remat recompute runs on the swapped tensors: bf16 copies with remat
    give the gradients of bf16 copies without it."""
    grads = {}
    for remat in (False, True):
        model = _model(checkpoint_activations=remat, **STOCHASTIC)
        names = [n for n, _ in model.named_parameters()]
        masters = [p for _, p in model.named_parameters()]
        tokens, images = _batch()

        def loss_fn(params):
            text, image = torch.func.functional_call(
                model.encoder_wrapper, params,
                kwargs=dict(src_tokens=tokens, src_images=images, encoder_type="vl",
                            deterministic=False, generator=torch.Generator().manual_seed(3)))[:2]
            return text.float().square().mean() + image.float().sin().mean()

        copies = {n.removeprefix("encoder_wrapper."): p.bfloat16()
                  for n, p in zip(names, masters) if n.startswith("encoder_wrapper.")}
        grads[remat] = torch.autograd.grad(loss_fn(copies), masters, allow_unused=True)
    for a, b in zip(grads[False], grads[True]):
        if a is not None:
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


def test_drop_path_schedule_and_layerdrop(monkeypatch):
    """Layer i gets drop path rate linspace(0, rate, layers)[i]; LayerDrop
    1.0 skips every layer, so only the final norms act."""
    seen = []
    orig = enc._run_layer

    def spy(layer, x, key_mask, bias, encoder_type, split_lens, rate, *rest):
        seen.append(rate)
        return orig(layer, x, key_mask, bias, encoder_type, split_lens, rate, *rest)

    monkeypatch.setattr(enc, "_run_layer", spy)
    model = _model(drop_path_rate=0.4)
    tokens, _ = _batch()
    with torch.no_grad():
        model.encoder_wrapper(src_tokens=tokens, encoder_type="text", deterministic=False,
                              generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(seen, np.linspace(0, 0.4, 3, dtype=np.float32))

    seen.clear()
    model = _model(layerdrop=1.0)
    with torch.no_grad():
        out = model.encoder_wrapper(src_tokens=tokens, encoder_type="text",
                                    deterministic=False,
                                    generator=torch.Generator().manual_seed(0))[0]
        x, pad, _ = model.encoder_wrapper.text_adapter(tokens)
        want = model.encoder_wrapper.fusion.text_layer_norm(x * (1.0 - pad[..., None].float()))
    assert seen == []
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_unported_remat_policies_raise():
    model = _model(checkpoint_activations=True, remat_policy="qkv")
    tokens, _ = _batch()
    with pytest.raises(NotImplementedError):
        model.encoder_wrapper(src_tokens=tokens, encoder_type="text")


def test_port_never_imports_jax():
    import subprocess

    code = ("import sys; import one_peace_tpu_torch.trainer, one_peace_tpu_torch.criterions, "
            "one_peace_tpu_torch.optim; assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
