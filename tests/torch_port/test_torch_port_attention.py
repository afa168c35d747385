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


def test_library_name_is_keyed_on_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a ``csrc/*.cuh`` header (the flash kernels include
    ``hopper_mma.cuh``) renames every library, so no stale one loads."""
    for f in ("flash_fwd.cu", "flash_bwd.cu", "hopper_mma.cuh"):
        (tmp_path / f).write_bytes(
            open(os.path.join(_build.CSRC, f), "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = {n: _build._lib_path(n) for n in ("flash_fwd", "flash_bwd")}
    assert {n: _build._lib_path(n) for n in first} == first
    with open(tmp_path / "hopper_mma.cuh", "a") as f:
        f.write("// edited\n")
    second = {n: _build._lib_path(n) for n in first}
    assert all(second[n] != first[n] for n in first)
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert all(_build._lib_path(n) not in (first[n], second[n])
               for n in first)


def test_flash_sources_include_the_hopper_header_and_name_both_routes():
    """Both flash sources build the tensor-core bodies from the shared
    header and keep the CUDA-core bodies; the kernels' names keep the
    substrings the profile attribution matches."""
    for name, syms in (("flash_fwd", ("flash_fwd_kernel",)),
                       ("flash_bwd", ("flash_dq_kernel", "flash_dkv_kernel"))):
        src = open(os.path.join(_build.CSRC, f"{name}.cu")).read()
        assert '#include "hopper_mma.cuh"' in src
        for sym in syms:
            assert f"{sym}_tc(" in src and f"{sym}(" in src
    hdr = open(os.path.join(_build.CSRC, "hopper_mma.cuh")).read()
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor",
                "mbarrier.try_wait", "wgmma.fence", "wgmma.commit_group",
                "wgmma.wait_group"):
        assert ptx in hdr


def test_flash_sources_route_bf16_d256_and_wide_forward_to_tensor_cores():
    """The C dispatchers send bf16 at D 256 to the tensor-core forward
    (one K/V stage there), dq (one warpgroup) and dk/dv (two warpgroups a
    CTA, each owning half of dK's and dV's columns), and the bf16
    forward at D 1024..8192 to ``flash_fwd_kernel_tc_wide`` ahead of the
    wide CUDA-core body; the CUDA-core D-256 instantiations stay for
    f32."""
    fwd = open(os.path.join(_build.CSRC, "flash_fwd.cu")).read()
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    assert "if (D == 256)\n      return launch_tc<256, DROP>(" in fwd
    assert "case 256: launch<T, 256, DROP>(" in fwd
    assert "if (D == 256) return launch_dkv_tc<256, DROP>(a, dk, dv);" in bwd
    assert "if (D == 256) return launch_dq_tc<256, DROP>(a, dq);" in bwd
    for body in ("launch_dq<T, 256, DROP>", "launch_dkv<T, 256, DROP>"):
        assert f"case 256: {body}(" in bwd
    assert "static constexpr int WGS = D > 128 ? 2 : 1;" in bwd
    # the forward's K/V ring: one stage at D 256 (two CTAs an SM)
    assert "static constexpr int STAGES = D > 128 ? 1 : 2;" in fwd
    # the wide bf16 forward: on the tensor cores, routed (inside the bf16
    # branch) before the wide CUDA-core body
    assert "flash_fwd_kernel_tc_wide(" in fwd
    route = fwd[fwd.index("int route("):]
    wide_tc = route.index("return launch_tc_wide<DROP>(")
    assert route.index("if (sizeof(T) == 2 && Sk > 0) {") < wide_tc
    assert wide_tc < route.index("return launch_wide<T, DROP>(")


def test_flash_sources_route_bf16_wide_backward_to_the_tensor_cores():
    """The backward's C dispatchers send bf16 at every wide width (D >=
    1024, inside the branch that also needs queries and keys) to
    ``flash_dq_kernel_tc_wide`` and ``flash_dkv_kernel_tc_wide`` ahead of
    the wide CUDA-core bodies, which f32 keeps; the header's width rule
    takes the powers of two to 8192 and the multiples of 8192 past it
    (F7), as the wrappers' ``_kernel_width`` pads; the D-512 CUDA-core
    bodies keep their own entry points."""
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    hdr = open(os.path.join(_build.CSRC, "hopper_mma.cuh")).read()
    for kern, tc, fma in (("dq", "return launch_dq_tc_wide<DROP>(a, D, dq);",
                           "return launch_dq_wide<T, DROP>(a, D, dq);"),
                          ("dkv", "return launch_dkv_tc_wide<DROP>(a, D, dk, "
                           "dv);", "return launch_dkv_wide<T, DROP>(a, D, "
                           "dk, dv);")):
        assert f"flash_{kern}_kernel_tc_wide(" in bwd
        route = bwd[bwd.index(f"int route_{kern}("):]
        route = route[:route.index("\n}\n")]
        branch = route.index("if (sizeof(T) == 2 && a.Sq > 0 && a.Sk > 0) {")
        assert branch < route.index(tc) < route.index(fma)
        assert f'extern "C" int apex_flash_{kern}_cuda_cores(' in bwd
    assert "constexpr int SPLIT = 8192;" in hdr
    assert "(D <= SPLIT ? (D & (D - 1)) == 0 : D % SPLIT == 0)" in hdr
    assert tattn.WIDE_SPLIT == 8192


@pytest.mark.parametrize("kern", ["dq", "dkv"])
def test_f32_wide_backward_launches_clusters_and_takes_no_atomics(kern):
    """The f32 wide dq and dk/dv (register tiles on the CUDA cores) launch
    their column slices as thread-block clusters of at most 8 CTAs (the
    header's ``launch_clusters``: ``cudaLaunchKernelEx`` with the
    cluster-dimension attribute, as the f32 wide forward), whose
    partial scores meet through distributed shared memory between split
    cluster barriers; the backward source has no atomics (one owner
    thread an output element, a fixed order of sums) and no longer the
    row sums across warps; dk/dv takes 32 key rows a CTA up to D 4096 and
    16 past it; the CUDA-core entry points take D 512 alone (from 1024
    f32 routes to the wide CUDA-core bodies, and bf16 has none there)."""
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    hdr = open(os.path.join(_build.CSRC, "hopper_mma.cuh")).read()
    rows = "_rows" if kern == "dkv" else ""
    launcher = bwd[bwd.index(f"int launch_{kern}_wide{rows}("):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert "return hopper::launch_clusters(" in launcher
    assert f"flash_{kern}_kernel_wide<T, {'ROWS, ' if rows else ''}DROP>," \
        in launcher
    assert "min(D / G::W, G::MAX_NC)" in launcher
    if rows:
        # 32 key rows x 512 columns while one cluster spans the row, 16 x
        # 1024 past it
        pick = bwd[bwd.index("int launch_dkv_wide("):]
        pick = pick[:pick.index("\n}\n")]
        assert "else if (D <= BwdWide::MAX_NC * DkvWide<32>::W)\n    return " \
            "launch_dkv_wide_rows<T, 32, DROP>(" in pick
        assert "launch_dkv_wide_rows<T, 16, DROP>(" in pick
    helper = hdr[hdr.index("int launch_clusters("):]
    helper = helper[:helper.index("\n}\n")]
    assert "cudaLaunchAttributeClusterDimension" in helper
    assert "cudaLaunchKernelEx(&cfg, kernel, args...)" in helper
    assert "static constexpr int MAX_NC = 8;" in bwd
    fwd = open(os.path.join(_build.CSRC, "flash_fwd.cu")).read()
    assert "return hopper::launch_clusters(\n      flash_fwd_kernel_wide<T, " \
        "DROP>," in fwd
    body = bwd[bwd.index(f"flash_{kern}_kernel_wide(const T*"):]
    body = body[:body.index("\n}\n")]
    for call in ("hopper::cluster_sync()", "hopper::cluster_arrive()",
                 "hopper::cluster_wait()", "part_sum<"):
        assert call in body
    for ptx in ("barrier.cluster.arrive.release", "barrier.cluster.wait."
                "acquire", "ld.shared::cluster.f32", "cp.async.cg.shared"):
        assert ptx in hdr
    assert "atomicAdd" not in bwd and "atom." not in bwd
    assert "row_sums" not in hdr + bwd and "wide::slice" not in bwd
    entry = bwd[bwd.index(f"int apex_flash_{kern}_cuda_cores("):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (D != 512) return static_cast<int>(cudaErrorInvalidValue);" \
        in entry and f"launch_{kern}_wide" not in entry


# the body each kernel takes (bf16; f32 takes the CUDA cores up to D 512):
# the tensor cores at these widths, the wide tensor-core bodies from D 512
# (f32 the wide CUDA-core bodies from D 1024)
_TC_ROUTE = {"flash_fwd": (64, 128, 256), "flash_dq": (64, 128, 256),
             "flash_dkv": (64, 128, 256)}
_TC_ROUTES = ("tensor cores", "wide tensor cores")


@pytest.mark.parametrize("kernel", sorted(_TC_ROUTE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", tattn.HEAD_DIMS + (16384, 24576))
def test_flash_route_names_each_kernels_body(kernel, dtype, d):
    """``flash_route`` names the body each kernel takes: bf16 forward, dq
    and dk/dv on the tensor cores at D 64, 128 and 256, on the wide
    tensor-core bodies at 512 (and 257..511, padded to it) and from 1024
    (past 8192 the multiples of 8192, F7); every f32 width up to 512 and
    bf16 at 16 and 32 on the CUDA cores; f32 from 1024 on the wide
    CUDA-core bodies.  A head dim pads to its kernel width first (D - 1
    routes as D, for D past 16); q, k, v and dO align to TMA's 16 bytes
    wherever a kernel of the call takes either tensor-core route."""
    bf16 = dtype == torch.bfloat16
    want = ("wide tensor cores" if d >= 512 and bf16 else
            "wide CUDA cores" if d >= 1024 else
            "tensor cores" if bf16 and d in _TC_ROUTE[kernel] else
            "CUDA cores")
    assert tattn.flash_route(kernel, dtype, d) == want
    if d > 16:
        assert tattn.flash_route(kernel, dtype, d - 1) == want
    tc = any(tattn.flash_route(k, dtype, d) in _TC_ROUTES
             for k in _TC_ROUTE)
    assert tattn._align(dtype, d) == (16 if tc else tattn._ALIGN[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d640_routes_only_the_bf16_forward_to_the_tensor_cores(dtype):
    """A D-640 head pads to 1024: bf16 runs its forward, dq and dk/dv on
    the wide tensor-core bodies (the backward's since their own bodies
    came); f32 runs all three on the wide CUDA-core bodies.  Either way
    the operands align to 16 bytes (the tensor-core bodies' TMA, f32's
    4-float vector)."""
    assert tattn._kernel_width(640) == 1024
    routes = {k: tattn.flash_route(k, dtype, 640) for k in _TC_ROUTE}
    wide = ("wide tensor cores" if dtype == torch.bfloat16
            else "wide CUDA cores")
    assert routes == {"flash_fwd": wide, "flash_dq": wide, "flash_dkv": wide}
    assert tattn._align(dtype, 640) == 16


@pytest.mark.parametrize("d", [300, 257, 511, 512])
def test_bf16_heads_257_to_512_run_the_wide_tensor_core_bodies(d):
    """A bf16 head of 257..512 (D 300, for one) pads to 512 and runs its
    forward, dq and dk/dv on the wide tensor-core bodies (D 512 divides
    into their 256- and 512-column slices), its operands 16-byte aligned
    for their TMA loads; f32 at those widths keeps the D-512 CUDA-core
    bodies."""
    assert tattn._kernel_width(d) == 512
    routes = {k: tattn.flash_route(k, torch.bfloat16, d) for k in _TC_ROUTE}
    assert routes == dict.fromkeys(_TC_ROUTE, "wide tensor cores")
    assert tattn._align(torch.bfloat16, d) == 16
    assert {tattn.flash_route(k, torch.float32, d) for k in _TC_ROUTE} == {
        "CUDA cores"}
    (p,) = tattn._operands(torch.randn(1, 2, 3, d).to(torch.bfloat16))
    assert p.shape == (1, 2, 3, 512) and p.data_ptr() % 16 == 0


def test_flash_sources_route_bf16_d512_to_the_wide_tensor_cores():
    """The header's tensor-core wide gate takes 512 and every wide width;
    the three C dispatchers and both wide tensor-core launchers use it,
    while the f32 wide CUDA-core bodies keep ``wide::MIN_D`` (1024) and
    the D-512 CUDA-core instantiations stay for f32 (and, in the
    CUDA-core entry points, for bf16 beside the routed bodies)."""
    fwd = open(os.path.join(_build.CSRC, "flash_fwd.cu")).read()
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    hdr = open(os.path.join(_build.CSRC, "hopper_mma.cuh")).read()
    assert "constexpr int TC_MIN_D = 512;" in hdr
    assert "return D == TC_MIN_D || takes(D);" in hdr
    assert "constexpr int MIN_D = 1024;" in hdr
    route = fwd[fwd.index("int route("):]
    route = route[:route.index("\n}\n")]
    assert route.index("if (sizeof(T) == 2 && Sk > 0) {") < route.index(
        "if (wide::tc_takes(D))\n      return launch_tc_wide<DROP>(")
    assert "if (D >= wide::MIN_D)\n    return launch_wide<T, DROP>(" in route
    assert "case 512: launch<T, 512, DROP>(" in route
    for kern, call in (("dq", "launch_dq_tc_wide<DROP>(a, D, dq)"),
                       ("dkv", "launch_dkv_tc_wide<DROP>(a, D, dk, dv)")):
        route = bwd[bwd.index(f"int route_{kern}("):]
        route = route[:route.index("\n}\n")]
        assert f"if (wide::tc_takes(D)) return {call};" in route
        assert f"if (D >= wide::MIN_D) return launch_{kern}_wide<T, DROP>(" \
            in route
        entry = bwd[bwd.index(f'int apex_flash_{kern}_cuda_cores('):]
        assert f"launch_{kern}<__nv_bfloat16, 512, true>(" in entry
    assert fwd.count("if (!wide::tc_takes(D))") == 1
    assert bwd.count("if (!wide::tc_takes(D) || D % ") == 2


def test_flash_route_rejects_an_unknown_kernel_and_width():
    """An unknown kernel raises; a width past 8192, which raised before
    F7, routes at its padded width (8193 runs at 16384)."""
    with pytest.raises(ValueError, match="flash_softmax"):
        tattn.flash_route("flash_softmax", torch.bfloat16, 64)
    for kernel in _TC_ROUTE:
        assert tattn.flash_route(kernel, torch.bfloat16, 8193) == (
            "wide tensor cores")
        assert tattn.flash_route(kernel, torch.float32, 8193) == (
            "wide CUDA cores")


def test_tensor_core_route_needs_16_byte_aligned_operands():
    """bf16 at D 64, 128 and 256 takes the tensor-core bodies, and bf16 at
    D 512 and 1024 the wide ones, whose TMA loads need q, k, v and dO
    16-byte aligned: a tensor 4 elements (8 bytes) into its storage is
    refused with a ValueError naming the alignment, where bf16 at D 16
    and 32 (the CUDA-core bodies, 8-byte words) takes it."""
    assert tattn._align(torch.bfloat16, 64) == 16
    assert tattn._align(torch.bfloat16, 128) == 16
    assert tattn._align(torch.bfloat16, 256) == 16
    assert tattn._align(torch.bfloat16, 512) == 16
    assert tattn._align(torch.bfloat16, 1024) == 16
    assert tattn._align(torch.bfloat16, 32) == 8
    assert tattn._align(torch.bfloat16, 16) == 8
    assert tattn._align(torch.float32, 64) == 16
    for d, refused in ((64, True), (128, True), (256, True), (512, True),
                       (1024, True), (32, False), (16, False)):
        t = torch.zeros(4 + 2 * 8 * d, dtype=torch.bfloat16)[4:]
        t = t.view(1, 2, 8, d)
        assert t.data_ptr() % 16 == 8
        check = lambda: tattn._check("q", t, t.dtype, t.device, t.shape,
                                     tattn._align(t.dtype, d))
        if refused:
            with pytest.raises(ValueError, match="16-byte aligned"):
                check()
        else:
            check()


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


def test_wrapper_pads_the_head_dim_and_copies_bad_operands():
    """What the card's wrappers do before a launch (F5): a head dim
    that is not a kernel width goes up to the next power of two from 16
    with zeros (F5b: 129..512 as well; F5c: 513..8192, the wide bodies;
    F7: past 8192 the next multiple of 8192); a strided operand is
    copied; a contiguous one that starts off its alignment is cloned to
    an aligned start; float64 raises TypeError."""
    assert [tattn._kernel_width(d) for d in (1, 8, 16, 17, 33, 80, 96,
                                             128, 129, 160, 192, 256, 257,
                                             512, 513, 640, 1024, 1025,
                                             5000, 8192, 8193, 16384,
                                             16385)] == [
        16, 16, 16, 32, 64, 128, 128, 128, 256, 256, 256, 256, 512, 512,
        1024, 1024, 1024, 2048, 8192, 8192, 16384, 16384, 24576]
    (big,) = tattn._operands(torch.randn(1, 1, 2, 8193))
    assert big.shape == (1, 1, 2, 16384) and torch.all(big[..., 8193:] == 0)
    (w,) = tattn._operands(torch.randn(1, 2, 3, 160))
    assert w.shape == (1, 2, 3, 256) and torch.all(w[..., 160:] == 0)
    q = torch.randn(2, 3, 5, 8)
    (p,) = tattn._operands(q)
    assert p.shape == (2, 3, 5, 16) and p.is_contiguous()
    assert torch.equal(p[..., :8], q) and torch.all(p[..., 8:] == 0)
    t = torch.randn(2, 5, 3, 64).transpose(1, 2)
    (c,) = tattn._operands(t)
    assert c.is_contiguous() and torch.equal(c, t)
    off = torch.randn(4 + 2 * 8 * 64).to(torch.bfloat16)[4:].view(1, 2, 8,
                                                                   64)
    assert off.is_contiguous() and off.data_ptr() % 16 == 8
    (a,) = tattn._operands(off)
    assert a.data_ptr() % 16 == 0 and torch.equal(a, off)
    (same,) = tattn._operands(c)
    assert same is c
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tattn._operands(q.double())
