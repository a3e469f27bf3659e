"""fp16's drift over depth in the port against the JAX package's, on CPU.

At the 4B geometry, the texts of the depth-40 golden reach cosine 0.984 in
fp16 on the card (``chip_smoke.py`` 21(b)), while images and audio reach
0.9995.  The golden's seeded weights (std 0.05 at width 1536, twice a
1/sqrt(width) init) make a deep stack that grows a small perturbation of a
short text layer by layer, so fp16's rounding, of the weights and of each
op's output, grows with it.  The JAX package cannot run that model on a CPU
here (16 GB of weights), so this holds the two packages to each other on a
model with the same depth and head width, and weights at the same ratio to
a 1/sqrt(width) init, but 256 wide: the same ``.pt`` through both
``from_pretrained``s in fp32 and in fp16, texts through the BPE.  The port's
fp16 text embeddings must leave its fp32 ones by as much as the JAX
package's leave its own (1 - cosine within a factor 2 either way; seeds
1-6 read ratios of 0.78-1.14), and the JAX package's must leave by more
than 5e-3 (so the model is deep enough for the drift to show; 1.3e-2 to
2.6e-2 over those seeds).  Run as a script, it prints each seed's readings.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

if __name__ == "__main__":  # run as a script: the repo and tests/ on the path
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).parent)]

import torch_fixture as tf  # noqa: E402
from chip_smoke import write_bpe_dir  # noqa: E402
from helpers import tiny_model_config  # noqa: E402
from one_peace_tpu import hub as jax_hub  # noqa: E402
from one_peace_tpu.core.config import TaskConfig  # noqa: E402
from one_peace_tpu_torch import hub  # noqa: E402

WIDTH, DEPTH, HEADS = 256, 40, 4  # head width 64, as the 4B model's
GOLDEN_TEMPERATURE = 0.05 * 1536 ** 0.5  # the golden's weight std over 1/sqrt(width)
TEXTS = ["a dog barking", "A cow in a field, mooing loudly!",
         "the quick brown fox jumps over", "x"]


def drift(root: Path, seed: int) -> dict:
    """1 - cosine between each package's fp16 and fp32 text embeddings (the
    mean over ``TEXTS``), and between the two packages' fp16 ones."""
    cfg = tiny_model_config(head_type="val")
    enc = cfg.encoder
    enc.embed_dim, enc.ffn_embed_dim, enc.layers, enc.attention_heads = (
        WIDTH, 4 * WIDTH, DEPTH, HEADS)
    enc.text_adapter.vocab_size = 300
    sd = tf.make_random_state_dict(cfg, seed=seed)
    for name in sd:  # the layers' matrices at the golden's ratio to a 1/sqrt(width) init
        if ".layers." in name and sd[name].ndim == 2:
            sd[name] = sd[name] * (GOLDEN_TEMPERATURE * WIDTH ** -0.5 / 0.05)
    pt = root / f"depth{seed}.pt"
    torch.save({"model": {k: torch.as_tensor(v) for k, v in sd.items()}}, pt)
    kw = dict(bpe_dir=write_bpe_dir(root / "bpe"), model_cfg=cfg,
              task_cfg=TaskConfig(patch_image_size=32))
    out = {}
    for dtype in ("float32", "fp16"):
        jh = jax_hub.from_pretrained(str(pt), dtype=dtype, **kw)
        th = hub.from_pretrained(str(pt), dtype=dtype, device="cpu", **kw)
        out["jax", dtype] = np.asarray(jh.extract_text_features(jh.process_text(TEXTS)),
                                       np.float64)
        out["port", dtype] = th.extract_text_features(th.process_text(TEXTS)).double().numpy()

    def gap(a, b):
        return float(np.mean([1 - x @ y / (np.linalg.norm(x) * np.linalg.norm(y))
                              for x, y in zip(a, b)]))

    return {"jax": gap(out["jax", "fp16"], out["jax", "float32"]),
            "port": gap(out["port", "fp16"], out["port", "float32"]),
            "jax vs port": gap(out["jax", "fp16"], out["port", "fp16"]),
            "fp32 jax vs port": gap(out["jax", "float32"], out["port", "float32"])}


@pytest.mark.parametrize("seed", [1, 2])
def test_fp16_drift_over_depth_matches_jax(tmp_path, seed):
    got = drift(tmp_path, seed)
    assert got["fp32 jax vs port"] < 1e-6, got
    assert got["jax"] > 5e-3, got
    assert 0.5 <= got["port"] / got["jax"] <= 2.0, got


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        for s in map(int, sys.argv[1:] or range(1, 7)):
            print(s, {k: f"{v:.3e}" for k, v in drift(Path(d), s).items()}, flush=True)
