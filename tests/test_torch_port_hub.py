"""The port's hub against the JAX package's, on CPU at toy size: one tiny
fairseq ``.pt`` (and the ``.npz`` export) loaded by both ``from_pretrained``s,
the ``process_*`` outputs and ``extract_{text,image,audio,vl}_features`` in
fp32 at 1e-4 with and without int8; the preprocessing pieces (bicubic resize,
log-mel fbank and the fbank adapter, the WAV decoder) against their JAX
counterparts; and ``cli/embed`` end to end against the JAX CLI.

A tiny byte-level BPE set (``chip_smoke.write_bpe_dir``) stands in for the
GPT-2 assets: ``encoder.json`` over the 256 byte symbols, a ``vocab.bpe``
with no merges, a 256-row ``dict.txt`` (dictionary ids 4..259).  Both
tokenizers read it the same way."""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_fixture as tf
from chip_smoke import write_bpe_dir
from helpers import tiny_model_config

from one_peace_tpu import hub as jax_hub
from one_peace_tpu.cli.embed import main as jax_embed_main
from one_peace_tpu.core.config import TaskConfig
from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.ops import preprocess as jax_pre
from one_peace_tpu.utils.checkpoint_convert import convert_retrieval_model
from one_peace_tpu.utils.native_checkpoint import save_params
from one_peace_tpu_torch import hub
from one_peace_tpu_torch.cli.embed import main as embed_main
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.ops import int8_matmul as im
from one_peace_tpu_torch.ops import preprocess
from one_peace_tpu_torch.utils.checkpoint import params_from_jax

TOL = 1e-4
SPEC = ((16, 10, 5), (16, 8, 8), (16, 8, 8))  # total stride 320: 15 s fits 1024 frames
TEXTS = ["a dog barking", "A cow in a field, mooing loudly!"]


def write_wav(path, samples, rate=16000, channels=1, width=2):
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(width)
        wf.setframerate(rate)
        if width == 2:
            data = (np.clip(samples, -1, 1) * 32767).astype(np.int16)
        else:
            data = (np.clip(samples, -1, 1) * 127 + 128).astype(np.uint8)
        wf.writeframes(data.tobytes())
    return str(path)


def hub_config():
    cfg = tiny_model_config(head_type="val")
    cfg.encoder.text_adapter.vocab_size = 300
    cfg.encoder.audio_adapter.feature_encoder_spec = SPEC
    return cfg


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("hub")
    cfg = hub_config()
    sd = tf.make_random_state_dict(cfg, seed=0)
    pt = root / "tiny.pt"
    torch.save({"model": {k: torch.as_tensor(v) for k, v in sd.items()}}, pt)
    npz = root / "tiny.npz"
    save_params(str(npz), convert_retrieval_model(sd, cfg))
    rng = np.random.RandomState(0)
    images = []
    for i, shape in enumerate([(40, 48, 3), (32, 32, 3)]):
        images.append(str(root / f"img{i}.png"))
        Image.fromarray(rng.randint(0, 255, shape, dtype=np.uint8)).save(images[-1])
    audios = [write_wav(root / "a0.wav", rng.randn(19200) * 0.3),
              write_wav(root / "a1.wav", rng.randn(4000) * 0.3, rate=8000)]
    return {"root": root, "cfg": cfg, "pt": str(pt), "npz": str(npz),
            "bpe": write_bpe_dir(root / "bpe"), "images": images, "audios": audios}


def _hubs(assets, path, quantize="none"):
    task = TaskConfig(patch_image_size=32)
    kw = dict(dtype="float32", bpe_dir=assets["bpe"], model_cfg=assets["cfg"], task_cfg=task,
              quantize=quantize)
    return (jax_hub.from_pretrained(path, **kw),
            hub.from_pretrained(path, device="cpu", **kw))


@pytest.fixture(scope="module")
def hubs(assets):
    return {q: _hubs(assets, assets["pt"], q) for q in ("none", "ffn", "ffn_attn")}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL)


def test_process_matches_jax(hubs, assets):
    jh, th = hubs["none"]
    np.testing.assert_array_equal(th.process_text(TEXTS).numpy(),
                                  np.asarray(jh.process_text(TEXTS)))
    np.testing.assert_array_equal(th.process_text(TEXTS, pad_to=40).numpy(),
                                  np.asarray(jh.process_text(TEXTS, pad_to=40)))
    (ti, tw, tht), (ji, jw, jht) = (h.process_image(assets["images"], return_image_sizes=True)
                                    for h in (th, jh))
    _close(ti.numpy(), ji)
    assert tw.tolist() == np.asarray(jw).tolist() and tht.tolist() == np.asarray(jht).tolist()
    for pad_to in (None, 16000 * 2):
        (tw_, tm), (jw_, jm) = (h.process_audio(assets["audios"], pad_to=pad_to)
                                for h in (th, jh))
        _close(tw_.numpy(), jw_)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("quantize", ["none", "ffn", "ffn_attn"])
@pytest.mark.parametrize("modality", ["text", "image", "audio", "vl"])
def test_features_match_jax(hubs, assets, quantize, modality):
    jh, th = hubs[quantize]
    before = (im.launches, im.quantize_launches)
    if modality == "text":
        got = th.extract_text_features(th.process_text(TEXTS))
        want = jh.extract_text_features(jh.process_text(TEXTS))
    elif modality == "image":
        got = th.extract_image_features(th.process_image(assets["images"]))
        want = jh.extract_image_features(jh.process_image(assets["images"]))
    elif modality == "audio":
        got = th.extract_audio_features(*th.process_audio(assets["audios"]))
        want = jh.extract_audio_features(*jh.process_audio(assets["audios"]))
    else:
        (timg, ttok), (jimg, jtok) = (h.process_image_text_pairs(
            list(zip(assets["images"], TEXTS))) for h in (th, jh))
        got, want = th.extract_vl_features(timg, ttok), jh.extract_vl_features(jimg, jtok)
        assert got[2] is None and want[2] is None
        for g, w in zip(got[:2], want[:2]):
            _close(g.numpy(), w)
        return
    assert got.shape == (2, 32) and not got.requires_grad
    _close(got.numpy(), want)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert (im.launches, im.quantize_launches) == before  # CPU tensors never launch


def test_npz_route_matches_pt(hubs, assets):
    jh, th = _hubs(assets, assets["npz"])
    tokens = th.process_text(TEXTS)
    got = th.extract_text_features(tokens)
    _close(got.numpy(), jh.extract_text_features(jh.process_text(TEXTS)))
    torch.testing.assert_close(got, hubs["none"][1].extract_text_features(tokens),
                               rtol=0, atol=0)


def test_bf16_quantizes_the_cast_weights(assets):
    """from_pretrained casts, then quantizes: the int8 bits are those of the
    bf16 weights, as in the JAX hub."""
    th = hub.from_pretrained(assets["pt"], dtype="bf16", bpe_dir=assets["bpe"],
                             model_cfg=assets["cfg"], task_cfg=TaskConfig(patch_image_size=32),
                             quantize="ffn", device="cpu")
    jh = jax_hub.from_pretrained(assets["pt"], dtype="bf16", bpe_dir=assets["bpe"],
                                 model_cfg=assets["cfg"],
                                 task_cfg=TaskConfig(patch_image_size=32), quantize="ffn")
    want = params_from_jax(jax.tree.map(np.asarray, jh.params))
    got = th.model.state_dict()
    for key in [k for k in got if k.endswith((".w_q", ".w_scale"))]:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)
    assert th.model.encoder_wrapper.fusion.layers[0].image_ffn.wo.bias.dtype == torch.bfloat16
    emb = th.extract_text_features(th.process_text(TEXTS))
    assert emb.dtype == torch.bfloat16 and torch.isfinite(emb.float()).all()


def test_unsupported_options_raise(assets, tmp_path):
    kw = dict(bpe_dir=assets["bpe"], model_cfg=assets["cfg"], device="cpu")
    with pytest.raises(NotImplementedError):
        hub.from_pretrained(assets["pt"], model_type="one_peace_classify", **kw)
    with pytest.raises(NotImplementedError):
        hub.from_pretrained(assets["pt"], dtype="fp16", **kw)
    with pytest.raises(NotImplementedError):  # an orbax directory
        hub.from_pretrained(str(tmp_path), **kw)
    with pytest.raises(ValueError):
        hub.from_pretrained(assets["pt"], quantize="int4", **kw)
    with pytest.raises(FileNotFoundError):
        hub.OnePeaceHubInterface(assets["cfg"], TaskConfig(), OnePeaceRetrievalModel(
            assets["cfg"]), bpe_dir=str(tmp_path))


@pytest.mark.parametrize("src,size", [((300, 400), 256), ((200, 180), 256), ((48, 40), 32)])
def test_resize_normalize_matches_jax(src, size):
    """F.interpolate bicubic with antialias against jax.image.resize bicubic,
    down and up; the JAX package documents ~6e-7 in [0, 1] units, here
    bounded at 1e-5 in normalised units (std ~0.27)."""
    raw = np.random.RandomState(sum(src)).randint(0, 256, (*src, 3), dtype=np.uint8)
    want = np.asarray(jax_pre.resize_normalize(jnp.asarray(raw), size, hub.CLIP_MEAN,
                                               hub.CLIP_STD))
    got = preprocess.resize_normalize(torch.as_tensor(raw), size, hub.CLIP_MEAN, hub.CLIP_STD)
    assert got.shape == (3, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_process_image_on_device(hubs, assets):
    """on_device=True against the JAX hub's on-device path at 1e-5, and
    against the host PIL path within the documented ~1e-2 (normalised)."""
    jh, th = hubs["none"]
    arr = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
    inputs = assets["images"] + [arr]
    got = th.process_image(inputs, on_device=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jh.process_image(inputs, on_device=True)),
                               rtol=0, atol=1e-5)
    host = th.process_image([assets["images"][1]])
    assert (got[1] - host[0]).abs().max() < 2e-2  # 32 px: no resize, rounding only


def test_mel_filterbank_is_a_copy():
    for args in ((80, 400, 16000), (40, 512, 16000, 20.0, 7000.0)):
        np.testing.assert_array_equal(preprocess.mel_filterbank(*args),
                                      jax_pre.mel_filterbank(*args))


@pytest.mark.parametrize("length", [400, 3999, 16000])
def test_log_mel_fbank_matches_jax(length):
    wav = np.random.RandomState(length).randn(2, length).astype(np.float32)
    ours, theirs = preprocess.LogMelFbank(), jax_pre.LogMelFbank()
    assert ours.num_frames(length) == theirs.num_frames(length)
    want = np.asarray(theirs(jnp.asarray(wav)))
    got = ours(torch.as_tensor(wav))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert ours(torch.zeros(1, 100)).shape == (1, 0, 80)


def test_fbank_adapter_matches_jax():
    """The fbank frontend (LN + projection of the log-mel frames, then the
    conv positions and the 2048-position rel table) through the whole
    retrieval model, on the JAX package's own init."""
    cfg = tiny_model_config(head_type="audio")
    ad = cfg.encoder.audio_adapter
    ad.frontend, ad.fbank_n_mels = "fbank", 16
    jax_model = JaxModel(cfg)
    tree = jax.tree.map(np.array, jax_model.init(jax.random.PRNGKey(3)))
    layers = tree["encoder_wrapper"]["fusion"]["layers"]
    layers["gamma_1"][:] = layers["gamma_2"][:] = 0.1
    table = tree["encoder_wrapper"]["audio_adapter"]["rel_pos_table"]
    table[:] = np.random.RandomState(0).randn(*table.shape) * 0.05
    model = OnePeaceRetrievalModel(cfg)
    model.load_state_dict(params_from_jax(tree), strict=True)
    adapter = model.encoder_wrapper.audio_adapter
    assert adapter.rp_bucket.shape[0] > 1024 and adapter.feature_extractor is None
    n = adapter.output_length(6000)
    assert n == jax_pre.LogMelFbank(n_mels=16).num_frames(6000)
    wav = np.random.RandomState(1).randn(2, 6000).astype(np.float32)
    pad = np.zeros((2, n + 1), bool)
    pad[1, -5:] = True
    want = np.asarray(jax_model(jax.tree.map(jnp.asarray, tree), src_audios=jnp.asarray(wav),
                                audio_padding_masks=jnp.asarray(pad), encoder_type="audio"))
    with torch.inference_mode():
        got = model(src_audios=torch.as_tensor(wav), audio_padding_masks=torch.as_tensor(pad),
                    encoder_type="audio")
    _close(got.numpy(), want)


def test_wav_decoder_is_a_copy(tmp_path):
    rng = np.random.RandomState(4)
    cases = [write_wav(tmp_path / "mono.wav", rng.randn(1600) * 0.3),
             write_wav(tmp_path / "stereo8k.wav", rng.randn(1600) * 0.3, rate=8000, channels=2),
             write_wav(tmp_path / "u8.wav", rng.randn(800) * 0.3, width=1)]
    for path in cases:
        np.testing.assert_array_equal(hub._load_wav(path), jax_hub._load_wav(path))
        np.testing.assert_array_equal(hub.load_audio(path), jax_hub.load_audio(path))
    arr = rng.randn(10)
    np.testing.assert_array_equal(hub.load_audio(arr), jax_hub.load_audio(arr))
    with pytest.raises(ValueError):
        hub.load_audio(str(tmp_path / "clip.mp3"))


def test_cli_embed_matches_jax_cli(assets, tmp_path, monkeypatch):
    """python -m one_peace_tpu_torch.cli.embed on PNG and WAV files against
    the JAX CLI on the same inputs and checkpoint."""
    monkeypatch.setenv("ONE_PEACE_BPE_DIR", assets["bpe"])
    texts = tmp_path / "texts.txt"
    texts.write_text("\n".join(TEXTS + ["third caption"]) + "\n")
    overrides = [
        "model.head_type=val", "model.encoder.embed_dim=32", "model.encoder.ffn_embed_dim=64",
        "model.encoder.layers=2", "model.encoder.attention_heads=4",
        "model.encoder.text_adapter.vocab_size=300", "model.encoder.text_adapter.bucket_size=8",
        "model.encoder.image_adapter.bucket_size=2",
        "model.encoder.image_adapter.rel_bucket_size=2",
        "model.encoder.audio_adapter.bucket_size=8", "model.encoder.audio_adapter.conv_pos_depth=2",
        "model.encoder.audio_adapter.conv_pos_width=6",
        "model.encoder.audio_adapter.conv_pos_groups=4",
        "model.encoder.audio_adapter.feature_encoder_spec=((16,10,5),(16,8,8),(16,8,8))",
        "task.max_duration=2"]
    common = ["--path", assets["pt"], "--texts", str(texts), "--images", *assets["images"],
              "--audios", *assets["audios"], "--batch-size", "2", "--dtype", "float32",
              "--patch-image-size", "32"]
    ours, theirs = tmp_path / "ours.npz", tmp_path / "theirs.npz"
    assert embed_main(common + ["--output", str(ours), "--device", "cpu"] + overrides) == 0
    assert jax_embed_main(common + ["--output", str(theirs)] + overrides) == 0
    with np.load(ours) as got, np.load(theirs) as want:
        assert sorted(got.files) == ["audio", "image", "text"]
        assert got["text"].shape == (3, 32) and got["audio"].shape == (2, 32)
        for key in got.files:
            assert got[key].dtype == np.float32
            _close(got[key], want[key])
