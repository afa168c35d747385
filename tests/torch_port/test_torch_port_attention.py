"""apex_tpu_torch.ops.attention against the JAX package's flash attention.

The same numpy inputs, made from a seed, go through
``apex_tpu.ops.attention.flash_attention`` (interpret-mode Pallas on the
CPU, as the JAX package's own tests run it) and through the port's
``flash_attention`` on the CPU, which is its plain PyTorch twin.  f32
throughout; tolerance ``atol=rtol=1e-5`` (the two sum the same products
in a different order).  The kernel itself runs only on the card:
``test_torch_port_cuda.py`` holds it against the plain version there.
"""

import os
import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from apex_tpu.ops import attention as jattn
from apex_tpu_torch import _build
from apex_tpu_torch.ops import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(rng, b, h, hk, sq, sk, d):
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    return q, k, v


def _ragged_seg(lengths, s):
    """(B, S) base segment ids: 1 on each row's first ``length``
    positions, 0 on the padded tail (prefill's form)."""
    return (np.arange(s)[None, :]
            < np.asarray(lengths)[:, None]).astype(np.int32)


def _packed_seg(b, s):
    """Two packed sequences per row and a padded tail."""
    seg = np.zeros((b, s), np.int32)
    seg[:, : s // 3] = 1
    seg[:, s // 3: s - s // 5] = 2
    return seg


def _run_both(q, k, v, causal, seg):
    jseg = None if seg is None else jattn.packed_segment_ids(
        jnp.asarray(seg))
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=jseg))
    tseg = None if seg is None else tattn.packed_segment_ids(
        torch.from_numpy(seg))
    got = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, segment_ids=tseg).numpy()
    return got, want


CASES = {
    # name: (b, h, hk, s, d, causal, seg kind)
    "causal": (2, 2, 2, 64, 32, True, None),
    "non_causal": (2, 2, 2, 48, 16, False, None),
    "causal_ragged_pad": (2, 2, 2, 64, 32, True, "ragged"),
    "non_causal_packed": (2, 2, 2, 60, 16, False, "packed"),
    "gqa_causal_ragged": (2, 4, 2, 64, 32, True, "ragged"),
    "mqa_causal_packed": (1, 4, 1, 40, 64, True, "packed"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(name):
    b, h, hk, s, d, causal, kind = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k, v = _qkv(rng, b, h, hk, s, s, d)
    seg = {"ragged": _ragged_seg([s, s // 2 + 3][:b], s),
           "packed": _packed_seg(b, s), None: None}[kind]
    got, want = _run_both(q, k, v, causal, seg)
    np.testing.assert_allclose(got, want, **TOL)
    if seg is not None:
        pad = seg == 0                                   # (B, S)
        assert np.all(got.transpose(0, 2, 1, 3)[pad] == 0.0)
        assert np.all(want.transpose(0, 2, 1, 3)[pad] == 0.0)


def test_flash_attention_multiblock_matches_jax(monkeypatch):
    """A geometry the TPU kernel tiles into 2x2 blocks (block cap 128,
    S=256): the online softmax across KV blocks and the causal clamp."""
    monkeypatch.setenv("APEX_TPU_ATTN_BLOCK_CAP", "128")
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 2, 1, 256, 256, 32)
    seg = _ragged_seg([200], 256)
    got, want = _run_both(q, k, v, True, seg)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[0, :, 200:] == 0.0)


def test_attention_ref_matches_jax_with_additive_mask():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 4, 2, 24, 24, 16)
    mask = np.where(rng.random((2, 1, 24, 24)) < 0.3, -1e30,
                    0.0).astype(np.float32)
    mask[..., 0] = 0.0                  # every row sees at least one key
    want = np.asarray(jattn.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        scale=0.3, mask=jnp.asarray(mask)))
    got = tattn.attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, scale=0.3, mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_packed_segment_ids_matches_jax():
    seg = _packed_seg(2, 30)
    want = jattn.packed_segment_ids(jnp.asarray(seg))
    got = tattn.packed_segment_ids(torch.from_numpy(seg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.int32


def test_flash_attention_rejects_bad_head_ratio():
    q = torch.zeros(1, 3, 4, 16)
    k = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tattn.flash_attention(q, k, k)


def test_kernel_is_registered_with_a_launch_count():
    assert tattn.FLASH_FWD in _build.KERNELS
    assert os.path.exists(os.path.join(_build.CSRC,
                                       f"{tattn.FLASH_FWD.name}.cu"))
    assert tattn.FLASH_FWD.launches == 0   # the CPU path never launches


# ---------------------------------------------------------------------------
# the build: failures raise, libraries are keyed on source and flags
# ---------------------------------------------------------------------------

def test_build_failure_raises_and_publishes_nothing(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed on broken.cu"):
        _build.library("broken")
    assert not any(p.suffix == ".so"
                   for p in (tmp_path / "_build").iterdir())
    assert "broken" not in _build._libs


def test_library_name_is_keyed_on_source_and_flags(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "k.cu").write_text("// v2\n")
    second = _build._lib_path("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._lib_path("k") not in (first, second)
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_kernel_launch_raises_on_a_cuda_error_and_counts_only_success():
    k = _build.Kernel("fake", "fake_fn", [])
    try:
        rcs = iter([0, 9])           # 9: cudaErrorInvalidConfiguration
        k._fn = lambda *args: next(rcs)
        k.launch()
        assert k.launches == 1
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            k.launch()
        assert k.launches == 1
        _build.reset_launch_counts()
        assert k.launches == 0
    finally:
        _build.KERNELS.remove(k)


def test_mixed_dtypes_promote_as_the_reference_does():
    """q bf16 with k, v f32: both packages promote the three to f32
    first, so the result is f32 and within the f32 tolerance; under
    autograd each gradient comes back in its input's dtype."""
    q, k, v = _qkv(np.random.default_rng(21), 1, 2, 2, 16, 16, 16)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    want = jattn.flash_attention(jq, jnp.asarray(k), jnp.asarray(v),
                                 causal=True)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = tattn.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                                causal=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tq.requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    tattn.flash_attention(tq, tk, torch.from_numpy(v), causal=True).sum(
        ).backward()
    assert tq.grad.dtype == torch.bfloat16 and tk.grad.dtype == torch.float32
