"""The port's attention wrappers on the CPU (their plain versions) held
against the JAX package's references and its Pallas kernels in interpret
mode, on the same numpy-seeded inputs. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.decode_attention import decode_ref as j_decode_ref  # noqa: E402,E501
from repro.kernels.decode_attention import flash_decode as j_flash_decode  # noqa: E402,E501
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402,E501
from repro.kernels.flash_attention import mha_ref as j_mha_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype: str) -> float:
    """tests/test_kernels.py's bars."""
    return 5e-2 if dtype == "bfloat16" else 2e-5


def _inputs(shapes, dtype: str, seed: int = 0):
    """The same normal draws as a JAX array and a CPU tensor of ``dtype``
    (both round f32 to bf16 to nearest even)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(x, jd), torch.from_numpy(x).to(td)))
    return out


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _assert_close(got, want, t):
    np.testing.assert_allclose(_np(got), _np(want), atol=t, rtol=t)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,t,h,kvh,d", [
    (2, 256, 256, 4, 2, 64),
    (1, 128, 384, 8, 8, 128),
    (2, 256, 256, 4, 1, 128),
    (1, 192, 192, 6, 2, 64),      # t not a multiple of the 128 block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_reference_and_pallas(b, s, t, h, kvh, d,
                                                      dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(b, s, h, d), (b, t, kvh, d), (b, t, kvh, d)], dtype)
    fa_ops.reset_launches()
    out = fa_ops.attention(qt, kt, vt, causal=True)
    assert fa_ops.launches["flash_attention"] == 0       # CPU: plain
    assert out.dtype == DTYPES[dtype][1] and out.shape == (b, s, h, d)
    _assert_close(out, j_mha_ref(qj, kj, vj, causal=True), tol(dtype))
    _assert_close(out, j_flash(qj, kj, vj, causal=True, interpret=True,
                               block_q=128, block_k=128), tol(dtype))


@pytest.mark.parametrize("b,s,t,h,kvh,d,causal,q_offset", [
    (1, 128, 256, 4, 4, 64, False, None),    # test_kernels' non-causal
    (1, 6, 6, 16, 2, 128, True, None),       # a frame: s < block, g = 8
    (1, 200, 200, 4, 2, 16, True, None),     # s not a block multiple, g=2
    (2, 70, 90, 4, 4, 32, True, 5),          # explicit q_offset, g = 1
])
def test_attention_plain_edge_shapes(b, s, t, h, kvh, d, causal, q_offset):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(b, s, h, d), (b, t, kvh, d), (b, t, kvh, d)], "float32", seed=1)
    kw = dict(causal=causal, q_offset=q_offset)
    out = fa_ops.attention(qt, kt, vt, **kw)
    _assert_close(out, j_mha_ref(qj, kj, vj, **kw), 2e-5)
    _assert_close(out, j_flash(qj, kj, vj, interpret=True, **kw), 2e-5)


def test_attention_ragged_kv_len_takes_the_plain_path():
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(3, 1, 4, 32), (3, 40, 2, 32), (3, 40, 2, 32)], "float32", seed=2)
    lens = np.array([40, 7, 1], np.int32)
    out = fa_ops.attention(qt, kt, vt, kv_len=torch.from_numpy(lens))
    _assert_close(out, j_mha_ref(qj, kj, vj, kv_len=jnp.asarray(lens)), 2e-5)


def test_gqa_head_mapping_is_repeat_not_tile():
    """q head i reads KV head i // g (jnp.repeat), not i % kvh."""
    b, t, kvh, g, d = 1, 5, 2, 4, 16
    v = torch.stack([torch.full((b, t, d), float(j)) for j in range(kvh)], 2)
    q = torch.randn(b, 3, kvh * g, d)
    out = fa_ref.mha_ref(q, torch.zeros_like(v), v, causal=False)
    heads = out[0, 0, :, 0]
    assert heads.tolist() == [float(i // g) for i in range(kvh * g)]
    expanded = fa_ref.expand_kv(v, kvh * g)
    assert torch.equal(expanded[..., 1, :], v[..., 0, :])
    assert torch.equal(expanded[..., g, :], v[..., 1, :])


def test_attention_impl_dispatch_on_cpu():
    q, k = torch.randn(1, 4, 2, 16), torch.randn(1, 4, 2, 16)
    with pytest.raises(ValueError, match="impl"):
        fa_ops.attention(q, k, k, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        fa_ops.attention(q, k, k, impl="cuda")
    torch.testing.assert_close(fa_ops.attention(q, k, k, impl="torch"),
                               fa_ops.attention(q, k, k))
    with pytest.raises(ValueError, match="impl"):
        dec_ops.decode_attention(q[:, 0], k, k,
                                 torch.tensor([2], dtype=torch.int32),
                                 impl="cuda")


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,kvh,d,blk", [
    (2, 512, 8, 2, 64, 128),
    (4, 1024, 4, 4, 128, 512),
    (1, 384, 8, 1, 128, 128),
    (3, 640, 16, 8, 64, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference_and_pallas(b, t, h, kvh, d, blk,
                                                   dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(b, h, d), (b, t, kvh, d), (b, t, kvh, d)], dtype, seed=3)
    lens = np.array([t // 2 + 37 * i for i in range(b)], np.int32)
    dec_ops.reset_launches()
    out = dec_ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert dec_ops.launches["flash_decode"] == 0
    assert out.dtype == DTYPES[dtype][1]
    _assert_close(out, j_decode_ref(qj, kj, vj, jnp.asarray(lens)),
                  tol(dtype))
    _assert_close(out, j_flash_decode(qj, kj, vj, jnp.asarray(lens),
                                      block_k=blk, interpret=True),
                  tol(dtype))


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 4), (16, 2)])
def test_decode_ragged_lengths_and_group_sizes(h, kvh):
    """g in {1, 2, 8}; lengths 1, a block edge, the whole cache."""
    b, t, d = 4, 256, 32
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(b, h, d), (b, t, kvh, d), (b, t, kvh, d)], "float32", seed=4)
    lens = np.array([1, 128, 129, t], np.int32)
    out = dec_ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    _assert_close(out, j_decode_ref(qj, kj, vj, jnp.asarray(lens)), 2e-5)
    _assert_close(out, j_flash_decode(qj, kj, vj, jnp.asarray(lens),
                                      block_k=128, interpret=True), 2e-5)


def test_decode_empty_cache_follows_the_kernel():
    """kv_len = 0: the TPU kernel runs no block and returns zeros; the
    port's plain version does the same. The JAX package's decode_ref
    takes a softmax over an all-masked row there and returns the mean of
    V (a reference fault, ROADMAP queue 3)."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(3, 8, 64), (3, 256, 2, 64), (3, 256, 2, 64)], "float32", seed=5)
    lens = np.array([0, 17, 0], np.int32)
    out = dec_ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    pallas = j_flash_decode(qj, kj, vj, jnp.asarray(lens), block_k=128,
                            interpret=True)
    _assert_close(out, pallas, 2e-5)
    assert not out[0].any() and not out[2].any()
    ref = np.asarray(j_decode_ref(qj, kj, vj, jnp.asarray(lens)))
    np.testing.assert_allclose(
        ref[0], np.repeat(np.asarray(vj)[0].mean(0), 4, axis=0), atol=1e-5)
    _assert_close(out[1], ref[1], 2e-5)
    torch.testing.assert_close(
        dec_ref.decode_ref(qt, kt, vt, torch.from_numpy(lens)), out)


def test_attention_sources_and_build_flags(tmp_path):
    """Each attention library builds for sm_90a without -fmad=false (its
    bar is a tolerance); the slot solver keeps its flags and hash. The
    sources define the entry points kernel.py binds, and no fast math."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.slot_solver import kernel as ss_kernel
    assert set(_build.NVCC_FLAGS) - set(_build.ATTENTION_FLAGS) == {
        "-fmad=false"}
    assert (_build.source_hash(ss_kernel.SOURCES)
            == _build.source_hash(ss_kernel.SOURCES, _build.NVCC_FLAGS))
    assert (_build.source_hash(fa_kernel.SOURCES, _build.ATTENTION_FLAGS)
            != _build.source_hash(fa_kernel.SOURCES))
    cmd = _build.build_command(fa_kernel.SOURCES, tmp_path / "a.so",
                               flags=_build.ATTENTION_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" not in cmd
    for mod, entry, kern in ((fa_kernel, "flash_attention_fwd",
                              "flash_attention_kernel"),
                             (dec_kernel, "flash_decode_fwd",
                              "flash_decode_kernel")):
        src = "".join(p.read_text() for p in mod.SOURCES)
        assert f"int {entry}(" in src and f"{kern}(" in src
        assert "-1e30f" in src
        assert not any(w in src for w in ("__expf", "use_fast_math",
                                          "scaled_dot_product"))


# ---------------------------------------------------------------------------
# flash decode's split schedule (the CUDA kernel's split and combine passes)
# ---------------------------------------------------------------------------

from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402,E501


@pytest.mark.parametrize("n_split,chunk", [(4, 64), (8, 32), (3, 96),
                                           (1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_matches_reference_and_pallas(n_split, chunk, dtype):
    """Per-split partials combined as the kernel does, against decode_ref
    and the Pallas kernel in interpret mode. Lanes: kv_len on a split
    boundary and beside it (so later splits are wholly beyond kv_len),
    1, t, and 0 (zeros, as the TPU kernel gives)."""
    b, t, h, kvh, d = 8, 256, 8, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(b, h, d), (b, t, kvh, d), (b, t, kvh, d)], dtype, seed=7)
    lens = np.array([chunk, chunk - 1, chunk + 1, 2 * chunk - 3 if
                     n_split > 1 else 200, 1, t, t - 1, 0], np.int32)
    out = dec_ref.decode_split_ref(qt, kt, vt, torch.from_numpy(lens),
                                   n_split, chunk)
    assert out.dtype == DTYPES[dtype][1]
    assert not out[-1].float().any()
    pallas = j_flash_decode(qj, kj, vj, jnp.asarray(lens), block_k=128,
                            interpret=True)
    _assert_close(out, pallas, tol(dtype))
    want = j_decode_ref(qj, kj, vj, jnp.asarray(lens))
    _assert_close(out[:-1], np.asarray(want, np.float32)[:-1], tol(dtype))
    _assert_close(out, dec_ref.decode_ref(qt, kt, vt, torch.from_numpy(lens)),
                  tol(dtype))


def test_combine_partials_is_the_softmax_merge():
    """Random partials: the combination equals softmax weights rebuilt from
    the raw maxima; empty partials carry no weight; all empty gives 0."""
    rng = np.random.default_rng(8)
    m = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 4, (3, 5)).astype(np.float32))
    acc = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    m[1, 2], l[1, 2], acc[1, 2] = -1e30, 0.0, float("nan")
    m[2], l[2] = -1e30, 0.0
    got = dec_ref.combine_partials(m, l, acc)
    m64, l64, a64 = m.double(), l.double(), acc.double()
    for row in (0, 1):
        live = l64[row] > 0
        w = torch.exp(m64[row][live] - m64[row][live].max())
        want = ((a64[row][live] * w[:, None]).sum(0)
                / (l64[row][live] * w).sum())
        np.testing.assert_allclose(got[row].numpy(), want.numpy(), rtol=1e-6)
    assert torch.equal(got[2], torch.zeros(16))


@pytest.mark.parametrize("b,t,kvh", [(8, 4096, 2), (8, 4096, 8), (1, 6, 2),
                                     (3, 640, 8), (1, 384, 1), (2, 512, 2),
                                     (64, 4096, 8), (2, 0, 1), (1, 33, 4)])
@pytest.mark.parametrize("n_sm", [132, 114])
def test_decode_split_plan(b, t, kvh, n_sm):
    """The host's split: a multiple of the tile, covering the cache with no
    empty split, and enough CTAs to cover the SMs twice wherever the cache
    has that many tiles. It reads no kv_len: its arguments are the cache's
    shape and the SM count alone."""
    import inspect
    assert list(inspect.signature(dec_kernel.split_plan).parameters) == [
        "b", "t", "kvh", "n_sm"]
    n_split, chunk = dec_kernel.split_plan(b, t, kvh, n_sm)
    tiles = -(-t // dec_kernel.TILE)
    assert chunk % dec_kernel.TILE == 0 and n_split >= 1
    assert (n_split - 1) * chunk < max(t, 1) <= n_split * chunk
    assert b * kvh * n_split >= min(2 * n_sm, b * kvh * max(tiles, 1))
    assert (b, t, kvh, n_sm) != (8, 4096, 2, 132) or (n_split, chunk) == (
        43, 96)


# ---------------------------------------------------------------------------
# flash attention's tile schedule and operand split (the CUDA kernel's
# plain versions)
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501

# (b, s, t, h, kvh, d, causal, q_offset): ragged s and t, s < t and s > t,
# an explicit q_offset of 5 and of -3 (rows before any key), full attention,
# and head dims 16, 144 and 256.
TILED_CASES = [
    (1, 200, 200, 4, 2, 16, True, None),
    (2, 70, 90, 4, 2, 64, True, 5),
    (1, 150, 133, 4, 4, 32, True, -3),
    (1, 130, 250, 4, 1, 144, False, None),
    (1, 96, 160, 2, 2, 256, True, None),
]


@pytest.mark.parametrize("case", TILED_CASES)
@pytest.mark.parametrize("tiling", fa_kernel.TILINGS)
def test_flash_tiled_ref_matches_reference_and_pallas(tiling, case):
    """The kernel's schedule (query tiles longest first, KV tiles with the
    online softmax, causal and per-warp tile skips, the -1e30 sentinel) at
    both tilings against mha_ref and the Pallas kernel in interpret mode.
    Rows that see no key are left out: each side averages another set of
    masked keys there."""
    _, bq, bk = tiling
    b, s, t, h, kvh, d, causal, q_offset = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(b, s, h, d), (b, t, kvh, d), (b, t, kvh, d)], "float32", seed=9)
    kw = dict(causal=causal, q_offset=q_offset)
    out = fa_ref.flash_tiled_ref(qt, kt, vt, block_q=bq, block_k=bk, **kw)
    assert out.dtype == torch.float32 and out.shape == (b, s, h, d)
    off = (t - s) if q_offset is None else q_offset
    rows = np.arange(s) + off >= 0 if causal else np.ones(s, bool)
    assert rows.sum() > s // 2
    got = _np(out)[:, rows]
    for want in (j_mha_ref(qj, kj, vj, **kw),
                 j_flash(qj, kj, vj, interpret=True, **kw)):
        np.testing.assert_allclose(got, _np(want)[:, rows], atol=2e-5,
                                   rtol=2e-5)


def test_flash_tiled_ref_bf16_follows_the_f32_schedule():
    """bf16 operands: the schedule computes in f32 and rounds once."""
    (_, qt), (_, kt), (_, vt) = _inputs(
        [(1, 80, 4, 64), (1, 80, 2, 64), (1, 80, 2, 64)], "bfloat16",
        seed=10)
    out = fa_ref.flash_tiled_ref(qt, kt, vt, block_q=128, block_k=64)
    assert out.dtype == torch.bfloat16
    want = fa_ref.flash_tiled_ref(qt.float(), kt.float(), vt.float(),
                                  block_q=128, block_k=64)
    assert torch.equal(out, want.bfloat16())


def test_split_tf32_rounds_to_nearest_tf32():
    """hi has 13 zero low bits and hi + lo == x exactly; hi is the nearer
    of the two TF32 neighbours of x, ties away from zero, over random
    magnitudes and bit patterns at, beside and on a rounding tie (and a
    carry into the exponent)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4000) * 10.0 ** rng.uniform(-30, 30, 4000))
    low = np.array([0x0000, 0x0001, 0x0fff, 0x1000, 0x1001, 0x1fff],
                   np.uint32)
    top = rng.integers(0, 0x7f000000, 500, dtype=np.uint32) & ~np.uint32(
        0x1fff)
    ties = (top[:, None] | low[None, :]).ravel()
    ties = np.concatenate([ties, ties | np.uint32(0x80000000),
                           np.array([0x3f7fffff, 0xbf7ff000, 0x3f801000,
                                     0], np.uint32)])
    x = np.concatenate([x.astype(np.float32), ties.view(np.float32)])
    hi, lo = fa_ref.split_tf32(torch.from_numpy(x))
    hb = hi.numpy().view(np.uint32)
    assert not (hb & 0x1fff).any()
    assert torch.equal(hi + lo, torch.from_numpy(x))
    xb = x.view(np.uint32)
    down = (xb & ~np.uint32(0x1fff)).view(np.float32).astype(np.float64)
    up = ((xb & ~np.uint32(0x1fff)) + 0x2000).view(np.float32).astype(
        np.float64)
    x64, h64 = x.astype(np.float64), hi.numpy().astype(np.float64)
    err = np.abs(x64 - h64)
    assert (err <= np.minimum(np.abs(x64 - down), np.abs(x64 - up))).all()
    tie = (xb & 0x1fff) == 0x1000
    assert (np.abs(h64[tie]) > np.abs(x64[tie])).all()


def test_kernel_tilings_match_the_cuda_source():
    """kernel.TILINGS (what the plain schedule and the tests use) is what
    csrc/flash_attention.cu's Tiling launches: BQ = 16 * WARPS, BK."""
    import re
    src = fa_kernel.SOURCES[0].read_text()
    for dmax, bq, bk in fa_kernel.TILINGS:
        m = re.search(rf"struct Tiling<{dmax}> \{{\n  static constexpr int "
                      r"WARPS = (\d+), BK = (\d+), NS = (\d+), AHEAD = (\d+);",
                      src)
        assert m, dmax
        warps, kb, ns, ahead = map(int, m.groups())
        assert (16 * warps, kb) == (bq, bk)
        assert ns in (ahead + 1, ahead + 2) and ns >= 2
        # f32 at the largest head dim: the Q tile and the ring fit a block's
        # 227 KB, and the SM's 228 KB (1 KB reserved per block) holds
        # blocks of at least 8 warps in all.
        smem = (16 * warps + ns * kb) * ((4 * dmax + 127) // 128 * 128 + 32)
        assert smem <= 232448
        assert warps * (233472 // (smem + 1024)) >= 8
    assert [fa_kernel.tiles(d) for d in (16, 128, 144, 256)] == [
        fa_kernel.TILINGS[0][1:]] * 2 + [fa_kernel.TILINGS[1][1:]] * 2
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.tiles(272)
