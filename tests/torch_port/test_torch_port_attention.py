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
    16 past it; the CUDA-core entry points take only the widths of the
    CUDA-core bodies, up to 512 (from 1024 f32 routes to the wide
    CUDA-core bodies, and bf16 has none there)."""
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    hdr = open(os.path.join(_build.CSRC, "hopper_mma.cuh")).read()
    rows = "_rows" if kern == "dkv" else "_w"
    launcher = bwd[bwd.index(f"int launch_{kern}_wide{rows}("):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert "return hopper::launch_clusters(" in launcher
    assert f"flash_{kern}_kernel_wide<T, " \
        f"{'ROWS, W' if kern == 'dkv' else 'W'}, DROP>," in launcher
    assert "min(D / G::W, G::MAX_NC)" in launcher
    if rows:
        # 32 key rows x 512 columns while one cluster spans the row, 16 x
        # 1024 past it
        pick = bwd[bwd.index("int launch_dkv_wide("):]
        pick = pick[:pick.index("\n}\n")]
        assert "else if (D <= BwdWide::MAX_NC * DkvWide<32>::W)\n    return " \
            "launch_dkv_wide_rows<T, 32, 512, DROP>(" in pick
        assert "launch_dkv_wide_rows<T, 16, 1024, DROP>(" in pick
    helper = hdr[hdr.index("int launch_clusters("):]
    helper = helper[:helper.index("\n}\n")]
    assert "cudaLaunchAttributeClusterDimension" in helper
    assert "cudaLaunchKernelEx(&cfg, kernel, args...)" in helper
    assert "static constexpr int MAX_NC = 8;" in bwd
    fwd = open(os.path.join(_build.CSRC, "flash_fwd.cu")).read()
    assert "return hopper::launch_clusters(\n      flash_fwd_kernel_wide<T, " \
        "W, DROP>," in fwd
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
    assert f"launch_{kern}_cuda_cores<float, false>(a, D, " in entry
    cores = bwd[bwd.index(f"int launch_{kern}_cuda_cores("):]
    cores = cores[:cores.index("\n}\n")]
    assert "case 512:" in cores and "case 1024:" not in cores
    assert "default: return static_cast<int>(cudaErrorInvalidValue);" \
        in cores
    assert f"launch_{kern}_wide" not in entry


@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("kern", ["fwd", "dq", "dkv"])
def test_f32_forward_and_dkv_at_256_and_512_take_register_tiles(kern, d):
    """The C dispatchers send the f32 forward, dq and dk/dv at kernel
    widths 256 and 512 (the header's ``wide::row_takes``, ahead of the
    CUDA-core bodies) to the register-tile bodies of the wide widths: the
    forward to ``FwdWide<D>`` and dq to ``DqWide<D>`` (a CTA on 64 rows
    and all D of O's or dQ's columns: no cluster), dk/dv to
    ``DkvWide<64>`` at 256 (four ring stages) and ``DkvWide<32>`` at 512
    (one CTA spans the row); ``flash_route`` names the same bodies, for
    D and the heads padded to it; the flash sources take no atomics; and
    the CUDA-core entry points launch the CUDA-core bodies at 256 and
    512 (as at every width they have), for f32 as for bf16."""
    fwd = open(os.path.join(_build.CSRC, "flash_fwd.cu")).read()
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    hdr = open(os.path.join(_build.CSRC, "hopper_mma.cuh")).read()

    def body(src, start):
        text = src[src.index(start):]
        return text[:text.index("\n}\n")]

    assert "constexpr bool row_takes(int D) {\n  return D == 256 || D == 512;" \
        in hdr
    src = fwd if kern == "fwd" else bwd
    route = body(src, "int route(" if kern == "fwd" else f"int route_{kern}(")
    cores = route.index(f"return launch_{'' if kern == 'fwd' else kern + '_'}"
                        "cuda_cores<T, DROP>(")
    wide = {"fwd": "launch_wide<T, DROP>(",
            "dq": "launch_dq_wide<T, DROP>(a, D, dq);",
            "dkv": "launch_dkv_wide<T, DROP>(a, D, dk, dv);"}[kern]
    row = route.index("if (sizeof(T) == 4 && wide::row_takes(D))\n"
                      f"    return {wide}")
    assert row < cores
    if kern != "fwd":
        cc = body(bwd, f"int launch_{kern}_cuda_cores(")
        assert f"case {d}: launch_{kern}<T, {d}, DROP>(" in cc
    if kern == "fwd":
        launch = body(fwd, "int launch_wide(")
        assert launch.index("if constexpr (sizeof(T) == 4) {") < launch.index(
            f"if (D == {d})\n      return launch_wide_w<T, {d}, DROP>(")
        assert "static constexpr bool CLUSTER = W >= wide::MIN_D;" in fwd
        assert "static constexpr int BQ = W >= wide::MIN_D ? 32 : 64;" in fwd
        assert "G::CLUSTER ? min(D / G::W, G::MAX_NC) : 1," in body(
            fwd, "int launch_wide_w(")
    if kern == "dq":
        launch = body(bwd, "int launch_dq_wide(")
        assert launch.index("if constexpr (sizeof(T) == 4) {") < launch.index(
            f"if (D == {d}) return launch_dq_wide_w<T, {d}, DROP>(")
        assert launch.index("if (!wide::takes(D))") > launch.index(
            f"launch_dq_wide_w<T, {d}, DROP>(")
        dq = bwd[bwd.index("struct DqWide : BwdWide {"):]
        dq = dq[:dq.index("\n};\n")]
        assert "static constexpr bool CLUSTER = W >= wide::MIN_D;" in dq
        assert "static constexpr int BQ = W >= wide::MIN_D ? 32 : 64;" in dq
        assert "G::CLUSTER ? min(D / G::W, G::MAX_NC) : 1," in body(
            bwd, "int launch_dq_wide_w(")
        kern_body = body(bwd, "flash_dq_kernel_wide(const T*")
        assert "const int nc = G::CLUSTER ? min(D / G::W, G::MAX_NC) : 1;" \
            in kern_body
        assert "G::CLUSTER ? static_cast<int>(hopper::cluster_rank()) * " \
            "part : 0;" in kern_body
    if kern == "dkv":
        launch = body(bwd, "int launch_dkv_wide(")
        rows = 16384 // d
        assert "template <int ROWS_, int W_ = 16384 / ROWS_>\n" \
            "struct DkvWide : BwdWide {" in bwd
        assert (f"else if (D == DkvWide<64>::W)\n    return launch_dkv_wide_"
                f"rows<T, 64, 256, DROP>(" if d == 256 else
                "else if (D <= BwdWide::MAX_NC * DkvWide<32>::W)\n    return "
                "launch_dkv_wide_rows<T, 32, 512, DROP>(") in launch
        assert rows == (64 if d == 256 else 32)
        assert "static constexpr int RING = (5 * STAGE + TAIL) * 4 <= " \
            "227 * 1024 ? 5 : 4;" in bwd
        assert "static constexpr int STAGES = W <= 64 ? 2 : RING;" in bwd
    want = "wide CUDA cores"
    for width in (d, d - 1, d // 2 + 1):
        assert tattn.flash_route(f"flash_{kern}", torch.float32, width) == want
        assert tattn.flash_route(f"flash_{kern}", torch.bfloat16,
                                 width) != "wide CUDA cores"
    assert "atomicAdd" not in fwd + bwd and "atom." not in fwd + bwd
    entry = body(src, f"int apex_flash_{kern}_cuda_cores(")
    cores = body(src, "int launch_cuda_cores(" if kern == "fwd" else
                 f"int launch_{kern}_cuda_cores(")
    assert f"case {d}: launch{'' if kern == 'fwd' else '_' + kern}<T, {d}, " \
        "DROP>(" in cores
    for dt in ("float", "__nv_bfloat16"):
        for drop in ("true", "false"):
            assert f"cuda_cores<{dt}, {drop}>(" in entry
    assert "_wide" not in entry and "route" not in entry



@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kern", ["fwd", "dq", "dkv"])
def test_f32_forward_and_dkv_at_64_and_128_take_register_tiles(kern, d):
    """The C dispatchers send the f32 forward (with keys to read), dq and
    dk/dv at kernel widths 64 and 128 (the header's ``wide::narrow_takes``,
    ahead of the CUDA-core bodies) to the register-tile bodies, one CTA on
    a row: the forward to ``FwdWide<D>`` (64 query rows, a two-stage ring,
    two CTAs an SM), dq to ``DqWide<D>`` (64 query rows, dS straight from
    each thread's blocks, a two-stage ring, two CTAs an SM) and dk/dv to
    ``DkvWide<64, D>`` (64 key rows x D); the f32 forward with no keys
    keeps its CUDA-core body (the three at 16 and 32 take the register
    tiles too, through the same predicate); ``flash_route``
    names the same bodies for D and the heads padded to it (33..127); and
    the CUDA-core entry points still launch the CUDA-core bodies at 64 and
    128."""
    fwd = open(os.path.join(_build.CSRC, "flash_fwd.cu")).read()
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    hdr = open(os.path.join(_build.CSRC, "hopper_mma.cuh")).read()

    def body(src, start):
        text = src[src.index(start):]
        return text[:text.index("\n}\n")]

    assert "constexpr bool narrow_takes(int D) {\n  return D == 16 || " \
        "D == 32 || D == 64 || D == 128;" in hdr
    src = fwd if kern == "fwd" else bwd
    route = body(src, "int route(" if kern == "fwd" else f"int route_{kern}(")
    cores = route.index(f"return launch_{'' if kern == 'fwd' else kern + '_'}"
                        "cuda_cores<T, DROP>(")
    narrow = {"fwd": "if (sizeof(T) == 4 && wide::narrow_takes(D) && Sk > 0)"
                     "\n    return launch_wide<T, DROP>(",
              "dq": "if (sizeof(T) == 4 && wide::narrow_takes(D))\n    "
                    "return launch_dq_wide<T, DROP>(a, D, dq);",
              "dkv": "if (sizeof(T) == 4 && wide::narrow_takes(D))\n    "
                     "return launch_dkv_wide<T, DROP>(a, D, dk, dv);"}[kern]
    assert route.index(narrow) < cores
    if kern == "fwd":
        launch = body(fwd, "int launch_wide(")
        assert launch.index("if constexpr (sizeof(T) == 4) {") < launch.index(
            f"if (D == {d})\n      return launch_wide_w<T, {d}, DROP>(")
        geo = fwd[fwd.index("struct FwdWide {"):]
        geo = geo[:geo.index("\n};\n")]
        assert "static constexpr bool NARROW = W < 256;" in geo
        assert "static constexpr int STAGES = NARROW ? 2 : 5;" in geo
        assert "__launch_bounds__(FwdWide<W>::THREADS, FwdWide<W>::CTAS)" \
            in fwd
    if kern == "dkv":
        launch = body(bwd, "int launch_dkv_wide(")
        assert f"else if (D == {d})\n    return launch_dkv_wide_rows<T, 64, " \
            f"{d}, DROP>(a, D, dk, dv);" in launch
        assert "wide::narrow_takes(D)" in launch
        assert "static constexpr bool DIRECT = W < 256;" in bwd
        assert "__launch_bounds__(DkvWide<ROWS, W>::THREADS,\n" \
            "                                  DkvWide<ROWS, W>::CTAS)" in bwd
    cc = body(src, "int launch_cuda_cores(" if kern == "fwd" else
              f"int launch_{kern}_cuda_cores(")
    assert f"case {d}: launch{'' if kern == 'fwd' else '_' + kern}<T, {d}, " \
        "DROP>(" in cc
    want = "wide CUDA cores"
    for width in (d, d - 1, d // 2 + 1):
        assert tattn._kernel_width(width) == d
        assert tattn.flash_route(f"flash_{kern}", torch.float32, width) == want
        assert tattn.flash_route(f"flash_{kern}", torch.bfloat16,
                                 width) == "tensor cores"
    for width in (16, 32):
        assert tattn.flash_route(f"flash_{kern}", torch.float32,
                                 width) == "wide CUDA cores"
    assert tattn._align(torch.float32, d) == 16
    entry = body(src, f"int apex_flash_{kern}_cuda_cores(")
    for dt in ("float", "__nv_bfloat16"):
        for drop in ("true", "false"):
            assert f"cuda_cores<{dt}, {drop}>(" in entry
    assert "_wide" not in entry and "route" not in entry

@pytest.mark.parametrize("d", [64, 128])
def test_f32_dq_at_64_and_128_picks_the_register_tile_body_of_its_width(d):
    """``launch_dq_wide`` picks ``launch_dq_wide_w<T, D, DROP>`` for f32 at
    kernel widths 64 and 128 (ahead of the wide widths' guard, as at 256
    and 512), which launches ``flash_dq_kernel_wide<T, D, DROP>``: 64
    query rows and all D of dQ's columns a CTA, no cluster; ``DqWide``
    gives those widths ``DIRECT`` (dS from each thread's whole blocks, no
    partials), a two-stage ring and two CTAs an SM (85 KB of shared
    memory a CTA), K's stages a whole 64-key tile at W 64, and dQ 4 rows x
    4 columns a thread there; the C dispatcher takes that route for f32
    only (bf16 keeps the tensor cores, and the dq with no keys never
    reaches the kernel: the wrapper zeros it)."""
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()

    def body(start):
        text = bwd[bwd.index(start):]
        return text[:text.index("\n}\n")]

    launch = body("int launch_dq_wide(")
    pick = f"if (D == {d}) return launch_dq_wide_w<T, {d}, DROP>(a, D, dq);"
    assert launch.index("if constexpr (sizeof(T) == 4) {") < launch.index(
        pick) < launch.index("if (!wide::takes(D))")
    assert "flash_dq_kernel_wide<T, W, DROP>," in body(
        "int launch_dq_wide_w(")
    geo = bwd[bwd.index("struct DqWide : BwdWide {"):]
    geo = geo[:geo.index("\n};\n")]
    for line in ("static constexpr bool DIRECT = W < 256;",
                 "static constexpr int PARTS = DIRECT ? 0 : 2 * SPART;",
                 "static constexpr int STAGES = DIRECT ? 2 : BwdWide::STAGES;",
                 "static constexpr int VK = W >= 128 ? BwdWide::STAGE / W : "
                 "TILE;",
                 "static constexpr int C = BQ * W >= 8192 ? BQ * W / 8192 : 1;",
                 "static constexpr int OR = BQ * W / (4 * THREADS * C);",
                 "static constexpr int CTAS = W < 64 ? 2 : 228 * 1024 / "
                 "(SMEM + 1024);"):
        assert line in geo, line
    assert "__launch_bounds__(DqWide<W>::THREADS, DqWide<W>::CTAS)" in bwd
    route = body("int route_dq(")
    narrow = route.index("if (sizeof(T) == 4 && wide::narrow_takes(D))\n"
                         "    return launch_dq_wide<T, DROP>(a, D, dq);")
    assert route.index("if (sizeof(T) == 2 && a.Sq > 0 && a.Sk > 0) {") \
        < narrow < route.index("return launch_dq_cuda_cores<T, DROP>(")
    assert f"if (D == {d}) return launch_dq_tc<{d}, DROP>(a, dq);" in route
    assert tattn.flash_route("flash_dq", torch.float32, d) == \
        "wide CUDA cores"
    assert tattn.flash_route("flash_dq", torch.bfloat16, d) == "tensor cores"


# the body each kernel takes (bf16): the tensor cores at these widths,
# the wide tensor-core bodies from D 512 (f32 the wide CUDA-core bodies,
# register tiles, from D 16: all three kernels at every width)
_TC_ROUTE = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"),
                          (16, 32, 64, 128, 256))
_F32_ROW_FROM = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"), 16)
_TC_ROUTES = ("tensor cores", "wide tensor cores")


@pytest.mark.parametrize("kernel", sorted(_TC_ROUTE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", tattn.HEAD_DIMS + (16384, 24576))
def test_flash_route_names_each_kernels_body(kernel, dtype, d):
    """``flash_route`` names the body each kernel takes: bf16 forward, dq
    and dk/dv on the tensor cores at D 16, 32, 64, 128 and 256, on the
    wide tensor-core bodies at 512 (and 257..511, padded to it) and from
    1024 (past 8192 the multiples of 8192, F7); f32 from 1024, and at 256
    and 512 (one CTA on a whole row), the f32 forward, dq and dk/dv at 16,
    32, 64 and 128 (one CTA on a row too), on the wide CUDA-core bodies
    (register tiles): no width routes to the CUDA-core bodies.  A head dim pads to its
    kernel width first (D - 1 routes as D, for D past 16); q, k, v and dO
    align to TMA's 16 bytes wherever a kernel of the call takes either
    tensor-core route."""
    bf16 = dtype == torch.bfloat16
    want = ("wide tensor cores" if d >= 512 and bf16 else
            "wide CUDA cores" if d >= 1024 else
            "wide CUDA cores" if not bf16 and d >= _F32_ROW_FROM[kernel] else
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
    for their TMA loads; f32 at those widths runs all three in register
    tiles (the wide CUDA-core bodies, one CTA on a whole row)."""
    assert tattn._kernel_width(d) == 512
    routes = {k: tattn.flash_route(k, torch.bfloat16, d) for k in _TC_ROUTE}
    assert routes == dict.fromkeys(_TC_ROUTE, "wide tensor cores")
    assert tattn._align(torch.bfloat16, d) == 16
    assert {k: tattn.flash_route(k, torch.float32, d) for k in _TC_ROUTE} == (
        dict.fromkeys(_TC_ROUTE, "wide CUDA cores"))
    (p,) = tattn._operands(torch.randn(1, 2, 3, d).to(torch.bfloat16))
    assert p.shape == (1, 2, 3, 512) and p.data_ptr() % 16 == 0


def test_flash_sources_route_bf16_d512_to_the_wide_tensor_cores():
    """The header's tensor-core wide gate takes 512 and every wide width;
    the three C dispatchers and both wide tensor-core launchers use it,
    while the f32 wide CUDA-core bodies keep ``wide::MIN_D`` (1024) and
    the D-512 CUDA-core instantiations stay for the CUDA-core entry
    points (either dtype, beside the routed bodies)."""
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
    assert "return launch_cuda_cores<T, DROP>(" in route
    cores = fwd[fwd.index("int launch_cuda_cores("):]
    assert "case 512: launch<T, 512, DROP>(" in cores[:cores.index("\n}\n")]
    entry = fwd[fwd.index('int apex_flash_fwd_cuda_cores('):]
    assert "launch_cuda_cores<__nv_bfloat16, true>(" in entry
    for kern, call in (("dq", "launch_dq_tc_wide<DROP>(a, D, dq)"),
                       ("dkv", "launch_dkv_tc_wide<DROP>(a, D, dk, dv)")):
        route = bwd[bwd.index(f"int route_{kern}("):]
        route = route[:route.index("\n}\n")]
        assert f"if (wide::tc_takes(D)) return {call};" in route
        assert f"if (D >= wide::MIN_D) return launch_{kern}_wide<T, DROP>(" \
            in route
        cores = bwd[bwd.index(f"int launch_{kern}_cuda_cores("):]
        assert f"case 512: launch_{kern}<T, 512, DROP>(" in cores
        entry = bwd[bwd.index(f'int apex_flash_{kern}_cuda_cores('):]
        assert f"launch_{kern}_cuda_cores<__nv_bfloat16, true>(" in entry
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
    """bf16 at D 16, 32, 64, 128 and 256 takes the tensor-core bodies (at
    16 and 32 the forward and dk/dv), and bf16 at D 512 and 1024 the wide
    ones, whose TMA loads need q, k, v and dO 16-byte aligned: a tensor 4
    elements (8 bytes) into its storage is refused with a ValueError
    naming the alignment; the same tensor from a 16-byte boundary is
    taken (bf16's own 8-byte word is the rule only where no kernel of the
    call reads by TMA, which no bf16 width is now)."""
    assert tattn._align(torch.bfloat16, 64) == 16
    assert tattn._align(torch.bfloat16, 128) == 16
    assert tattn._align(torch.bfloat16, 256) == 16
    assert tattn._align(torch.bfloat16, 512) == 16
    assert tattn._align(torch.bfloat16, 1024) == 16
    assert tattn._align(torch.bfloat16, 32) == 16
    assert tattn._align(torch.bfloat16, 16) == 16
    assert tattn._align(torch.float32, 64) == 16
    assert all(tattn._align(torch.bfloat16, d) == 16
               for d in tattn.HEAD_DIMS)
    for d, refused in ((64, True), (128, True), (256, True), (512, True),
                       (1024, True), (32, True), (16, True), (16, False),
                       (32, False)):
        t = torch.zeros(8 + 2 * 8 * d, dtype=torch.bfloat16)
        t = (t[4:-4] if refused else t[8:]).view(1, 2, 8, d)
        assert t.data_ptr() % 16 == (8 if refused else 0)
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


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("kern", ["fwd", "dq", "dkv"])
def test_bf16_forward_and_dkv_at_16_and_32_take_the_tensor_cores(kern, d):
    """The C dispatchers send the bf16 forward (with keys to read), dq and
    dk/dv (with queries and keys) at D 16 and 32 to their tensor-core
    bodies at the head's own width, ahead of every other route; the f32
    forward with no keys keeps its CUDA-core body (the f32 forward with
    keys, dq and dk/dv take the register tiles), which the CUDA-core
    entry points still launch at 16 and 32; ``flash_route``
    names the same bodies for D and the heads padded to it, and q, k, v
    and dO align to TMA's 16 bytes there."""
    fwd = open(os.path.join(_build.CSRC, "flash_fwd.cu")).read()
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()

    def body(src, start):
        text = src[src.index(start):]
        return text[:text.index("\n}\n")]

    src = fwd if kern == "fwd" else bwd
    route = body(src, "int route(" if kern == "fwd" else f"int route_{kern}(")
    branch = route.index("if (sizeof(T) == 2 && Sk > 0) {" if kern == "fwd"
                         else "if (sizeof(T) == 2 && a.Sq > 0 && a.Sk > 0) {")
    cores = route.index(f"return launch_{'' if kern == 'fwd' else kern + '_'}"
                        "cuda_cores<T, DROP>(")
    line = {"fwd": f"if (D == {d})\n      return launch_tc<{d}, DROP>(q, k, "
                   "v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, "
                   "st);",
            "dq": f"if (D == {d}) return launch_dq_tc<{d}, DROP>(a, dq);",
            "dkv": f"if (D == {d}) return launch_dkv_tc<{d}, DROP>(a, dk, "
                   "dv);"}[kern]
    assert branch < route.index(line) < cores
    assert route.index(line) < route.index(
        "if (D == 64)\n      return launch_tc<64" if kern == "fwd"
        else f"if (D == 64) return launch_{kern}_tc<64")
    cc = body(src, "int launch_cuda_cores(" if kern == "fwd" else
              f"int launch_{kern}_cuda_cores(")
    assert f"case {d}: launch{'' if kern == 'fwd' else '_' + kern}<T, {d}, " \
        "DROP>(" in cc
    entry = body(src, f"int apex_flash_{kern}_cuda_cores(")
    for dt in ("float", "__nv_bfloat16"):
        for drop in ("true", "false"):
            assert f"cuda_cores<{dt}, {drop}>(" in entry
    for width in (d, d - 1, d // 2 + 1):
        assert tattn._kernel_width(width) == d
        assert tattn.flash_route(f"flash_{kern}", torch.bfloat16,
                                 width) == "tensor cores"
        assert tattn.flash_route(f"flash_{kern}", torch.float32,
                                 width) == "wide CUDA cores"
        assert tattn._align(torch.bfloat16, width) == 16
        assert tattn._align(torch.float32, width) == 16


@pytest.mark.parametrize("d, swizzle", [(16, "32B"), (32, "64B"),
                                        (64, "128B")])
def test_narrow_tensor_core_tiles_take_the_swizzle_of_their_width(d, swizzle):
    """A head of 16 or 32 columns is one panel as wide as the row: the
    forward's, dq's and dk/dv's TMA maps take a box of ``PW`` columns
    (``D`` at 16 and 32, 64 from 64) with the swizzle of that row's bytes
    (``swizzle_of``: 32, 64, 128), which ``make_map_bf16`` refuses to
    pair with any other box; the wgmma descriptors take the layout type
    of the same swizzle (CUTLASS's GMMA::LayoutType: 3, 2, 1), 8 rows of
    ``SW`` bytes between 8-row groups, and the products of width ``PW``
    (``wgmma_rs<PW>``: m64n16k16, m64n32k16, m64n64k16)."""
    fwd = open(os.path.join(_build.CSRC, "flash_fwd.cu")).read()
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    hdr = open(os.path.join(_build.CSRC, "hopper_mma.cuh")).read()
    sw = {16: 32, 32: 64, 64: 128}[d]
    lines = {16: "return box_cols == 16 ? CU_TENSOR_MAP_SWIZZLE_32B",
             32: ": box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B",
             64: ": CU_TENSOR_MAP_SWIZZLE_128B;"}
    swizzle_of = hdr[hdr.index("inline CUtensorMapSwizzle swizzle_of("):]
    assert lines[d] in swizzle_of[:swizzle_of.index("\n}\n")]
    assert f"CU_TENSOR_MAP_SWIZZLE_{swizzle}" in lines[d]
    make = hdr[hdr.index("inline int make_map_bf16("):]
    make = make[:make.index("\n}\n")]
    assert "int box_rows, int box_cols = 64,\n" \
        "                         CUtensorMapSwizzle swz = " \
        "CU_TENSOR_MAP_SWIZZLE_128B) {" in make
    assert "if (swz != swizzle_of(box_cols))" in make
    assert "const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols)," \
        in make
    desc = hdr[hdr.index("__device__ __forceinline__ uint64_t desc_sw("):]
    assert "(SW == 128 ? 1 : SW == 64 ? 2 : 3) << 62" in desc
    wrappers = {16: "m64n16k16", 32: "m64n32k16", 64: "m64n64k16"}
    assert f"wgmma.mma_async.sync.aligned.{wrappers[d]}.f32.bf16.bf16" in hdr
    for src, geo, launch in ((fwd, "struct FwdTc {", "int launch_tc("),
                             (bwd, "struct DkvTc {", "int launch_dkv_tc("),
                             (bwd, "struct DqTc {", "int launch_dq_tc(")):
        g = src[src.index(geo):]
        g = g[:g.index("\n};\n")]
        assert "static constexpr int PW = D < 64 ? D : 64;" in g
        assert "static constexpr int SW = 2 * PW;" in g
        assert min(d, 64) * 2 == sw
        lb = src[src.index(launch):]
        lb = lb[:lb.index("\n}\n")]
        assert "const CUtensorMapSwizzle swz = hopper::swizzle_of(G::PW);" \
            in lb
        assert lb.count(", G::PW, swz);") == (3 if src is fwd else 4)
        assert "hopper::wgmma_rs<G::PW, 1>(" in src
        assert "hopper::desc_sw<SW>(" in src and "8 * SW)" in src


def _src_body(src, start, end="\n}\n"):
    text = src[src.index(start):]
    return text[:text.index(end)]


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_tensor_core_dq_takes_panels_of_the_heads_width(d):
    """``DqTc<D>`` has ``DkvTc``'s panel geometry: ``PW`` columns a panel
    (the head's own 16 or 32, else 64), rows of ``SW = 2 PW`` bytes, ``NP
    = D / PW`` panels and ``NA = PW / 2`` f32 of dQ a thread a panel.  S
    and dP read Q, dO, K and V K-major (k16 steps of 32 bytes within a
    panel), dQ += dS.K reads the same K tile MN-major (a k16 step is 16
    key rows, 16 SW bytes) as m64nPWk16 products; the epilogue writes
    ``NA / 4`` words of two bf16 a thread a panel, which over the
    fragment's 32 lanes cover each row's D columns once; the ring's
    stages and shared memory follow ``STAGES``."""
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    geo = _src_body(bwd, "struct DqTc {", "\n};\n")
    for line in ("static constexpr int PW = D < 64 ? D : 64;",
                 "static constexpr int SW = 2 * PW;",
                 "static constexpr int NP = D / PW;",
                 "static constexpr int NA = PW / 2;",
                 "static constexpr int NS = BK / 2;",
                 "static constexpr int KID_OFF = V_OFF + STAGES * KV_BYTES;",
                 "static constexpr int BAR_OFF = KID_OFF + STAGES * BK * 4;"):
        assert line in geo, line
    kern = _src_body(bwd, "flash_dq_kernel_tc(const __grid_constant__")
    for text in ("hopper::desc_sw<SW>(qs + p * G::BQ * SW + off, 16, 8 * SW)",
                 "hopper::desc_sw<SW>(kt + p * BK * SW + off, 16, 8 * SW)",
                 "hopper::desc_sw<SW>(dos + p * G::BQ * SW + off, 16, 8 * SW)",
                 "hopper::desc_sw<SW>(vt + p * BK * SW + off, 16, 8 * SW)",
                 "hopper::wgmma_rs<G::PW, 1>(",
                 "hopper::desc_sw<SW>(kt + p * BK * SW + c * 16 * SW, BK * SW,",
                 "for (int j = 0; j < G::NA / 4; ++j)",
                 "qrow[(G::PW / 2) * p + 4 * j + (lane & 3)] ="):
        assert text in kern, text
    assert "desc_sw<128>" not in kern and "64 * p" not in kern
    pw = d if d < 64 else 64
    na = pw // 2
    # the m64nN fragment: lane l's words j of a panel hold columns 8 j +
    # 2 (l & 3) and the next, of rows r_lo and r_lo + 8
    words = sorted((pw // 2) * p + 4 * j + (lane & 3)
                   for p in range(d // pw) for j in range(na // 4)
                   for lane in range(4))
    assert words == list(range(d // 2))
    launch = _src_body(bwd, "int launch_dq_tc(")
    assert "hopper::swizzle_of(G::PW)" in launch
    assert launch.count(", G::PW, swz);") == 4
    route = _src_body(bwd, "int route_dq(")
    assert route.index(f"if (D == {d}) return launch_dq_tc<{d}, DROP>(a, "
                       "dq);") < route.index("return launch_dq_cuda_cores<")
    assert tattn.flash_route("flash_dq", torch.bfloat16, d) == "tensor cores"


def _fwd_wide_geometry(w):
    """``FwdWide<W>``'s constants (csrc/flash_fwd.cu), for a width W."""
    threads = 128 if w < 64 else 256
    bq = 32 if w >= 1024 else 64
    bk, dc = 64, (w if w < 64 else 64)
    ks, rs = 64 // bq, bq // 4
    sb = bk * rs * ks // threads
    c = bq * w // 8192 if bq * w >= 8192 else 1
    return dict(threads=threads, bq=bq, dc=dc, ks=ks, rs=rs, sb=sb,
                kg=bk // sb, tpr=threads // bq, nx=bk // (threads // bq),
                c=c, orows=bq * w // (4 * threads * c), cg=w // (4 * c))


# BwdWide's constants (csrc/flash_bwd.cu)
_BWD = dict(threads=256, dc=64, stage=8192, stages=5, tile=64)
_BWD["spart"] = 64 * (_BWD["tile"] + 8)


def _dq_wide_geometry(w):
    """``DqWide<W>``'s constants (csrc/flash_bwd.cu), for a width W."""
    threads = 128 if w < 64 else _BWD["threads"]
    tile = _BWD["tile"]
    dc = w if w < 64 else _BWD["dc"]
    pad = dc + 4
    bq = 32 if w >= 1024 else 64
    ks, rs = 64 // bq, bq // 4
    sb = tile * rs * ks // threads
    c = bq * w // 8192 if bq * w >= 8192 else 1
    vk = _BWD["stage"] // w if w >= 128 else tile
    kstage = vk * w if w < 64 else _BWD["stage"]
    stage = max((bq + tile) * pad, kstage)
    direct = w < 256
    stages = 2 if direct else _BWD["stages"]
    smem = (stages * stage + (0 if direct else 2 * _BWD["spart"])
            + tile * (bq + 4)) * 4
    return dict(threads=threads, tile=tile, dc=dc, bq=bq, ks=ks, rs=rs,
                sb=sb, kg=tile // sb, c=c, orows=bq * w // (4 * threads * c),
                cg=w // (4 * c), vk=vk, stage=stage, direct=direct,
                smem=smem,
                ctas=2 if w < 64 else 228 * 1024 // (smem + 1024))


def _dkv_wide_geometry(w):
    """``DkvWide<ROWS, W>``'s constants (csrc/flash_bwd.cu) at the rows
    ``launch_dkv_wide`` gives a width W (64 up to 256, 32 at 512)."""
    rows = 64 if w <= 256 else 32
    threads = 128 if w < 64 else _BWD["threads"]
    tile = _BWD["tile"]
    dc = w if w < 64 else _BWD["dc"]
    pad = dc + 4
    ks, rs = 64 // rows, rows // 4
    sb = tile * rs * ks // threads
    c = 2 if rows * w >= 16384 else 1
    qk = tile if w < 64 else _BWD["stage"] // (2 * w)
    ustage = qk * 2 * w
    stage = max((rows + tile) * pad, ustage)
    direct = w < 256
    prow = rows + 4
    tail = (0 if direct else 2 * _BWD["spart"]) + 2 * tile * prow + 3 * tile
    ring = 5 if (5 * stage + tail) * 4 <= 227 * 1024 else 4
    stages = 2 if w <= 64 else ring
    smem = (stages * stage + tail) * 4
    return dict(threads=threads, tile=tile, rows=rows, ks=ks, rs=rs, sb=sb,
                kg=tile // sb, c=c, orows=rows * w // (4 * threads * c),
                cg=w // (4 * c), qk=qk, ustage=ustage, stage=stage,
                direct=direct, smem=smem,
                ctas=(2 if w == 32 else 3 if w < 64
                      else 228 * 1024 // (smem + 1024)))


@pytest.mark.parametrize("kern", ["fwd", "dq", "dkv"])
def test_f32_forward_alone_takes_register_tiles_at_16_and_32(kern):
    """(Named when the forward alone took them.)  The header's
    ``wide::narrow_takes`` (D 16, 32, 64 and 128) sends the f32 forward
    with keys, the dq and the dk/dv at 16 and 32 to their register-tile
    bodies, ahead of the CUDA-core bodies, which the CUDA-core entry
    points still launch there for timing in turns.  ``FwdWide``,
    ``DqWide`` and ``DkvWide<64, W>`` at W 16 / 32 take a stage of S as
    wide as the head and 128 threads: 4 x 8 blocks of S (of S^T in
    dk/dv), 4 and 2 rows of the output's 64 x W a thread, two CTAs an SM
    (three in dk/dv at 16); their tiles cover the CTA and fit the SM at
    every width from 16 to 512 (the static_asserts' arithmetic);
    ``flash_route`` names "wide CUDA cores" at D and at the heads padded
    to it."""
    fwd = open(os.path.join(_build.CSRC, "flash_fwd.cu")).read()
    bwd = open(os.path.join(_build.CSRC, "flash_bwd.cu")).read()
    hdr = open(os.path.join(_build.CSRC, "hopper_mma.cuh")).read()
    assert "constexpr bool narrow_takes(int D) {\n  return D == 16 || " \
        "D == 32 || D == 64 || D == 128;" in hdr
    assert "fwd_narrow_takes" not in hdr + fwd + bwd
    src = fwd if kern == "fwd" else bwd
    route = _src_body(src, "int route(" if kern == "fwd"
                      else f"int route_{kern}(")
    line = {"fwd": "if (sizeof(T) == 4 && wide::narrow_takes(D) && Sk > 0)"
                   "\n    return launch_wide<T, DROP>(",
            "dq": "if (sizeof(T) == 4 && wide::narrow_takes(D))\n    "
                  "return launch_dq_wide<T, DROP>(a, D, dq);",
            "dkv": "if (sizeof(T) == 4 && wide::narrow_takes(D))\n    "
                   "return launch_dkv_wide<T, DROP>(a, D, dk, dv);"}[kern]
    assert route.index(line) < route.index(
        f"return launch_{'' if kern == 'fwd' else kern + '_'}cuda_cores<T, "
        "DROP>(")
    launch = _src_body(src, "int launch_wide(" if kern == "fwd" else
                       f"int launch_{kern}_wide(")
    cores = _src_body(src, "int launch_cuda_cores(" if kern == "fwd" else
                      f"int launch_{kern}_cuda_cores(")
    for w in (16, 32):
        pick = {"fwd": f"if (D == {w})\n      return launch_wide_w<T, {w}, "
                       "DROP>(",
                "dq": f"if (D == {w}) return launch_dq_wide_w<T, {w}, "
                      "DROP>(a, D, dq);",
                "dkv": f"else if (D == {w})\n    return launch_dkv_wide_rows"
                       f"<T, 64, {w}, DROP>(a, D, dk, dv);"}[kern]
        assert launch.index(pick) < launch.index(
            "if (D == 64)" if kern != "dkv" else "else if (D == 64)")
        assert f"case {w}: launch{'' if kern == 'fwd' else '_' + kern}<T, " \
            f"{w}, DROP>(" in cores
    geo = _src_body(src, {"fwd": "struct FwdWide {", "dq": "struct DqWide : "
                          "BwdWide {", "dkv": "struct DkvWide : BwdWide {"}
                    [kern], "\n};\n")
    lines = ["static constexpr int DC = W < 64 ? W : "
             + ("64;" if kern == "fwd" else "BwdWide::DC;"),
             "static constexpr int THREADS = W < 64 ? 128 : "
             + ("256;" if kern == "fwd" else "BwdWide::THREADS;")]
    if kern == "fwd":
        lines += ["static constexpr int SB = BK * RS * KS / THREADS;",
                  "static constexpr int OR = BQ * W / (4 * THREADS * C);"]
    else:
        rows = "BQ" if kern == "dq" else "ROWS"
        lines += ["static constexpr int SB = TILE * RS * KS / THREADS;",
                  f"static constexpr int OR = {rows} * W / (4 * THREADS * C);",
                  "static constexpr int CTAS = W < 64 ? 2 : 228 * 1024 / "
                  "(SMEM + 1024);" if kern == "dq" else
                  "static constexpr int CTAS = W == 32 ? 2 : W < 64 ? 3 :\n"
                  "                              228 * 1024 / (SMEM + 1024);",
                  "static_assert(KS * RS * KG == THREADS,"]
    for text in lines:
        assert text in geo, text
    for w in (16, 32, 64, 128, 256, 512):
        if kern == "fwd":
            g = _fwd_wide_geometry(w)
            assert g["ks"] * g["rs"] * g["kg"] == g["threads"]
            assert g["nx"] <= 32 and g["bq"] * g["dc"] // 4 % g["threads"] == 0
            assert g["bq"] // g["orows"] * g["cg"] == g["threads"]
            continue
        g = (_dq_wide_geometry if kern == "dq" else _dkv_wide_geometry)(w)
        rows = g["bq"] if kern == "dq" else g["rows"]
        assert g["ks"] * g["rs"] * g["kg"] == g["threads"]
        assert g["orows"] % 4 == 0 or g["orows"] < 4
        assert rows // g["orows"] * g["cg"] == g["threads"]
        assert g["smem"] <= 227 * 1024
        assert (g["smem"] + 1024) * g["ctas"] <= 228 * 1024
        assert not g["direct"] or g["ks"] == 1
        if kern == "dq":
            assert g["vk"] % (g["threads"] // (w // 4)) == 0
            assert g["tile"] % g["vk"] == 0 and g["vk"] * w <= g["stage"]
            assert g["cg"] % 32 == 0 or 32 % g["cg"] == 0
        else:
            assert g["tile"] % g["qk"] == 0
            assert g["ustage"] // 4 % g["threads"] == 0
            assert g["threads"] >= g["tile"]
    narrow = {w: (_fwd_wide_geometry if kern == "fwd" else _dq_wide_geometry
                  if kern == "dq" else _dkv_wide_geometry)(w) for w in (16, 32)}
    assert (narrow[32]["threads"], narrow[32]["sb"], narrow[32]["orows"],
            narrow[16]["orows"]) == (128, 8, 4, 2)
    if kern != "fwd":
        assert (narrow[32]["ctas"], narrow[16]["ctas"]) == (
            (2, 2) if kern == "dq" else (2, 3))
        # the narrow ring stages: a stage of S (S^T) as wide as the head
        assert [narrow[w]["stage"] for w in (16, 32)] == [128 * 20, 128 * 36]
        assert [narrow[w]["smem"] for w in (16, 32)] == (
            [37888, 54272] if kern == "dq" else [56064, 72448])
        for w in (64, 128, 256, 512):
            g = (_dq_wide_geometry if kern == "dq" else _dkv_wide_geometry)(w)
            assert (g["threads"], g["sb"], g["kg"]) == (256, 4, 16)
    for w in (16, 32):
        assert tattn.flash_route(f"flash_{kern}", torch.float32,
                                 w) == "wide CUDA cores"
        assert tattn.flash_route(f"flash_{kern}", torch.float32,
                                 w - 3) == "wide CUDA cores"


# the twins at the BERT proxy's head dim (and 16), bf16, against the
# reference's Pallas kernels in interpret mode: a small proxy-like shape
# unmasked, and packed segment ids with pad rows under the causal mask.
# Both round p (before P.V and dV) and ds (before dQ and dK) to bf16 and
# each result once; a last-bit f32 difference (exp or summation order)
# can flip one of those roundings, so the outputs agree within one bf16
# rounding, 2**-7 of their scale; lse is f32 and agrees within 1e-5
NARROW_TWIN_CASES = {
    # name: (b, h, s, d, causal, packed)
    "proxy_like_d32": (2, 4, 64, 32, False, False),
    "d32_packed_causal": (2, 4, 64, 32, True, True),
    "d16_unmasked": (2, 4, 64, 16, False, False),
    "d16_packed": (2, 4, 60, 16, False, True),
}


@pytest.mark.parametrize("name", sorted(NARROW_TWIN_CASES))
def test_narrow_bf16_twins_match_the_pallas_kernels(name):
    b, h, s, d, causal, packed = NARROW_TWIN_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    seg = _packed_seg(b, s) if packed else None
    jseg = None if seg is None else jattn.packed_segment_ids(
        jnp.asarray(seg))
    tseg = None if seg is None else tattn.packed_segment_ids(
        torch.from_numpy(seg))
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    sc = 1.0 / np.sqrt(d)
    jo, jlse = jattn._fwd_pallas(jq, jk, jv, sc, causal, jseg, need_lse=True)
    to, tlse = tattn.flash_fwd_ref(tq, tk, tv, causal, sc, tseg)

    def close(got, want):
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=2.0 ** -7 * max(float(np.abs(want).max()), 1e-30))

    close(to, jo)
    lse = np.array(jlse)[:, :s, 0]
    np.testing.assert_allclose(tlse.numpy(), lse, rtol=1e-5, atol=1e-5)
    want = jattn._bwd_pallas(jq, jk, jv, jo, jnp.asarray(lse), jdo, sc,
                             causal, jseg)
    got = tattn.flash_bwd_ref(
        tq, tk, tv, torch.from_numpy(np.array(jo.astype(jnp.float32)))
        .to(torch.bfloat16), torch.from_numpy(lse), tdo, causal, sc, tseg)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == (b, h, s, d)
        close(g, w)
    if seg is not None:
        pad = seg == 0
        for t in (to,) + tuple(got):
            assert np.all(t.float().numpy().transpose(0, 2, 1, 3)[pad] == 0)


# the port's standing rules: no module of the port (nor chip_smoke.py)
# imports JAX or the JAX package, even inside a function; the entry points
# run on the card unless given device="cpu"; a wrapper takes its plain
# twin only for a CPU tensor
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PORT = os.path.join(_ROOT, "apex_tpu_torch")
_PORT_PARTS = sorted(
    {n for n in os.listdir(_PORT)
     if os.path.isdir(os.path.join(_PORT, n)) and not n.startswith("_")
     and any(f.endswith(".py") for f in os.listdir(os.path.join(_PORT, n)))}
    | {"(top level)", "chip_smoke.py"})


@pytest.mark.parametrize("part", _PORT_PARTS)
def test_no_port_module_imports_jax_even_lazily(part):
    """Every import statement anywhere in the port's files (module level
    or inside a function, where a fresh-interpreter import check cannot
    see it) and in chip_smoke.py names neither jax, jaxlib, flax nor the
    JAX package."""
    import ast
    if part == "chip_smoke.py":
        files = [os.path.join(_ROOT, part)]
    elif part == "(top level)":
        files = [os.path.join(_PORT, f) for f in os.listdir(_PORT)
                 if f.endswith(".py")]
    else:
        files = [os.path.join(r, f)
                 for r, _, fs in os.walk(os.path.join(_PORT, part))
                 for f in fs if f.endswith(".py")]
    assert files
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad = [n for n in names if n.split(".")[0] in
                   ("jax", "jaxlib", "flax", "apex_tpu")]
            assert not bad, (path, node.lineno, bad)


@pytest.mark.parametrize("example", ["bert_pretrain_mlm", "gpt_train_block",
                                     "imagenet_main_amp"])
def test_entry_points_run_on_the_card_unless_given_the_cpu(example):
    """A trainer called without ``device=`` means the card: with none
    visible it raises naming ``device="cpu"`` before it builds anything
    (where a card is visible, the default resolves to it)."""
    import importlib
    from apex_tpu_torch._device import resolve_device
    mod = importlib.import_module(f"apex_tpu_torch.examples.{example}")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mod.train(steps=1, log=None)


@pytest.mark.parametrize("side", ["fwd", "bwd"])
def test_flash_wrappers_take_the_twin_only_for_a_cpu_tensor(side):
    """A tensor off the CPU (here the meta device, which no kernel takes)
    goes to the kernel's wrapper and is refused there; it never reaches
    ``flash_fwd_ref`` / ``flash_bwd_ref``."""
    q = torch.empty(1, 2, 8, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        if side == "fwd":
            tattn._fwd(q, q, q, True, None, None, True, 0.0, None)
        else:
            lse = torch.empty(2, 8, device="meta")
            tattn._bwd(q, q, q, q, lse, q, True, None, None, 0.0, None)
