"""The decode of a cache whose rows are split over ranks, on one process:
``decode_attention``'s split pass run on each block of rows
(``ref.decode_partials_ref`` and the ``decode_split`` wrapper) and the
combine pass over every block's partials (``ref.combine_partials`` and
``decode_combine``), against the JAX package's ``decode_ref`` and its
Pallas ``flash_decode`` in interpret mode on the same numpy draws.

The cache of 256 rows is cut into R in {1, 2, 4, 8} blocks, as that many
ranks would hold it; each block reads its rows below kv_len - offset
(clamped to [0, rows]). Lengths end inside the first block, on a block
boundary and beside it, at 1 and at t; one sequence is empty. Bars:
``tests/test_kernels.py``'s, 2e-5 in f32 and 5e-2 in bf16.
"""
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
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402,E501
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, T, H, KVH, D = 8, 256, 8, 2, 32


def tol(dtype: str) -> float:
    return 5e-2 if dtype == "bfloat16" else 2e-5


def _inputs(dtype: str, seed: int = 11):
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    out = []
    for shape in ((B, H, D), (B, T, KVH, D), (B, T, KVH, D)):
        x = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(x, jd), torch.from_numpy(x).to(td)))
    return out


def _lengths(rows: int) -> np.ndarray:
    """Inside the first block, on a block boundary and beside it, 1, t,
    t - 1, and 0 (an empty sequence)."""
    inside = max(rows // 2, 1)
    return np.array([inside, rows, rows + 1, 2 * rows - 1, 1, T, T - 1, 0],
                    np.int32)


def _blocks(q, k, v, lens, n_blocks: int, partials):
    """Every block's partials [b, h, n, d + 2], side by side in row order,
    each from ``partials(q, k_block, v_block, local_len)``."""
    rows = T // n_blocks
    ws = []
    for r in range(n_blocks):
        local = (lens - r * rows).clamp(0, rows).to(torch.int32)
        sl = slice(r * rows, (r + 1) * rows)
        ws.append(partials(q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                           local))
    return torch.cat(ws, dim=2)


def _ref_partials(q, k, v, kv_len):
    n, chunk = dec_kernel.split_plan(q.shape[0], k.shape[1], k.shape[2])
    m, l, acc = dec_ref.decode_partials_ref(q, k, v, kv_len, n, chunk)
    return torch.cat([acc, m[..., None], l[..., None]], dim=-1)


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_combined_match_reference_and_pallas(n_blocks, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(dtype)
    lens = _lengths(T // n_blocks)
    lt = torch.from_numpy(lens)
    ws = _blocks(qt, kt, vt, lt, n_blocks, _ref_partials)
    d = D
    out = dec_ref.combine_partials(ws[..., d], ws[..., d + 1],
                                   ws[..., :d]).to(qt.dtype)
    assert not out[-1].float().any()
    pallas = j_flash_decode(qj, kj, vj, jnp.asarray(lens), block_k=128,
                            interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pallas, np.float32),
                               atol=tol(dtype), rtol=tol(dtype))
    want = np.asarray(j_decode_ref(qj, kj, vj, jnp.asarray(lens)),
                      np.float32)
    np.testing.assert_allclose(out[:-1].float().numpy(), want[:-1],
                               atol=tol(dtype), rtol=tol(dtype))
    # The wrappers on the CPU are the same two plain passes, bitwise.
    wrapped = dec_ops.decode_combine(
        _blocks(qt, kt, vt, lt, n_blocks, dec_ops.decode_split), qt.dtype)
    assert torch.equal(wrapped, out)


@pytest.mark.parametrize("kv_len", [0, -5])
def test_empty_block_carries_no_weight(kv_len):
    """A block the sequence has not reached (its local kv_len <= 0): every
    split gives l = 0, m = NEG_INF and acc = 0, and beside a live block it
    leaves the combine bitwise what the live block gives alone."""
    (_, qt), (_, kt), (_, vt) = _inputs("float32", seed=12)
    half = T // 2
    empty = _ref_partials(qt, kt[:, half:].contiguous(),
                          vt[:, half:].contiguous(),
                          torch.full((B,), kv_len, dtype=torch.int32))
    assert not empty[..., D + 1].any() and not empty[..., :D].any()
    assert torch.all(empty[..., D] == dec_ref.NEG_INF)
    live = _ref_partials(qt, kt[:, :half].contiguous(),
                         vt[:, :half].contiguous(),
                         torch.full((B,), 40, dtype=torch.int32))
    both = torch.cat([live, empty], dim=2)
    assert torch.equal(dec_ops.decode_combine(both, torch.float32),
                       dec_ops.decode_combine(live, torch.float32))
    none = dec_ops.decode_combine(empty, torch.float32)
    assert not none.any()


def test_split_wrappers_equal_the_one_call_schedule_on_the_cpu():
    """One block: the split and combine wrappers give bitwise the plain
    split schedule under the card's plan, count no launch, and refuse
    malformed partials."""
    (_, qt), (_, kt), (_, vt) = _inputs("float32", seed=13)
    lt = torch.from_numpy(_lengths(64))
    dec_ops.reset_launches()
    ws = dec_ops.decode_split(qt, kt, vt, lt)
    n, chunk = dec_kernel.split_plan(B, T, KVH)
    assert ws.shape == (B, H, n, D + 2) and ws.dtype == torch.float32
    got = dec_ops.decode_combine(ws, qt.dtype)
    assert torch.equal(got, dec_ref.decode_split_ref(qt, kt, vt, lt, n,
                                                     chunk))
    assert not any(dec_ops.launches.values())
    with pytest.raises(ValueError, match="partials"):
        dec_ops.decode_combine(ws[..., 0], torch.float32)


def test_split_entries_in_the_source():
    """The CUDA source defines the two entries kernel.py binds, beside the
    one-call entry, each running the same kernels."""
    src = "".join(p.read_text() for p in dec_kernel.SOURCES)
    for entry in ("flash_decode_fwd", "flash_decode_split",
                  "flash_decode_combine"):
        assert f"int {entry}(" in src
    assert src.count("flash_decode_kernel<T, 8>") == 1
    assert src.count("flash_decode_combine_kernel<T>;") == 1
