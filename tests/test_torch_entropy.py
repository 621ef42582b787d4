"""The torch port's entropy stage against the JAX package's.

Seeded quantized blocks go through the JAX functions on the CPU and through
their torch counterparts with CPU tensors, which select the kernels' plain
versions: symbol streams, restart-group dense words (hybrid merge) and the
carried stream. Everything is integer: the tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_stitch_tpu.ops import jpeg_entropy_device as J
from image_stitch_tpu_torch.ops import jpeg_entropy_device as E
from tests.utils.torch_port import TABLES, u32

torch.set_num_threads(1)

JAX_LUTS = J.build_entropy_luts(*TABLES)
LUTS = E.entropy_luts_from_numpy({k: np.asarray(v) for k, v in JAX_LUTS.items()}, "cpu")

# One compiled program per reference call (eager dispatch compiles op by op).
symbol_streams_flat_ref = jax.jit(J._symbol_streams_flat, static_argnums=(4, 5))
symbol_streams_ref = jax.jit(J._symbol_streams, static_argnums=(5,))
pack_groups_ref = jax.jit(
    J.jpeg_pack_groups_from_blocks_trace,
    static_argnames=("n_groups", "cap_words", "sampling", "local_words", "merge"),
)
pack_carried_ref = jax.jit(
    J.entropy_pack_trace_v2, static_argnames=("cap_words", "local_words", "sampling")
)


def random_blocks(rng, n: int) -> np.ndarray:
    """(n, 64) int16 natural-order quantized blocks: sparse random ACs,
    large magnitudes, all-zero blocks, a last coefficient that is nonzero
    (no EOB) and long zero runs that need ZRL."""
    b = rng.integers(-60, 61, (n, 64)) * (rng.random((n, 64)) < rng.random((n, 1)) * 0.6)
    b[:, 0] = rng.integers(-1000, 1001, n)
    b[rng.random(n) < 0.1, 1:] = 0
    b[::7, 63] = rng.integers(1, 5)
    b[::5, 1:] = 0
    b[::5, 50] = -1023  # zigzag position far from the DC: ZRL runs
    b[3::11, 5] = 1023
    return b.astype(np.int16)


def component_blocks(seed: int, n_mcu: int, sampling: str):
    rng = np.random.default_rng(seed)
    ny = 4 * n_mcu if sampling == "420" else n_mcu
    return random_blocks(rng, ny), random_blocks(rng, n_mcu), random_blocks(rng, n_mcu)


def to_torch(blocks):
    return [torch.from_numpy(b) for b in blocks]


def test_luts_match_jax_tables():
    own = E.build_entropy_luts(*TABLES, "cpu")
    for k in ("dc_code", "dc_len", "ac_code", "ac_len", "zrl_code", "zrl_len",
              "eob_code", "eob_len", "zigzag"):
        assert torch.equal(own[k], LUTS[k]), k


@pytest.mark.parametrize("sampling,n_groups", [("444", 3), ("420", 2)])
def test_symbol_streams_flat_match_jax(sampling, n_groups):
    blocks = component_blocks(n_groups, 6 * n_groups, sampling)
    ref_c, ref_l = symbol_streams_flat_ref(*blocks, JAX_LUTS, n_groups, sampling)
    got_c, got_l = E._symbol_streams_flat(*to_torch(blocks), LUTS, n_groups, sampling)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(u32(got_c), np.asarray(ref_c))


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_symbol_streams_carried_match_jax(sampling):
    blocks = component_blocks(9, 10, sampling)
    prev = np.array([17, -300, 5], np.int32)
    ref_c, ref_l, ref_dc = symbol_streams_ref(*blocks, JAX_LUTS, jnp.asarray(prev), sampling)
    got_c, got_l, got_dc = E._symbol_streams(
        *to_torch(blocks), LUTS, torch.from_numpy(prev), sampling
    )
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(u32(got_c), np.asarray(ref_c))
    np.testing.assert_array_equal(got_dc.numpy(), np.asarray(ref_dc))


@pytest.mark.parametrize("sampling,n_groups", [("444", 4), ("420", 2), ("444", 1)])
def test_groups_match_jax_hybrid(sampling, n_groups):
    blocks = component_blocks(20 + n_groups, 5 * n_groups, sampling)
    cap_words, lw = 256, 24
    ref = pack_groups_ref(
        *blocks, JAX_LUTS, n_groups=n_groups, cap_words=cap_words, sampling=sampling,
        local_words=lw, merge="hybrid",
    )
    got = E.pack_groups_from_blocks(*to_torch(blocks), LUTS, n_groups, cap_words,
                                    sampling=sampling, local_words=lw)
    assert int(np.asarray(ref[2])) <= lw * 32  # no budget overflow
    used = int(((np.asarray(ref[1]) + 31) // 32).sum())
    assert used <= n_groups * cap_words  # no capacity overflow
    np.testing.assert_array_equal(u32(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[2]) == int(np.asarray(ref[2]))
    assert int(got[3]) == int(np.asarray(ref[3])) == 0


@pytest.mark.parametrize("sampling,bit_base", [("444", 0), ("444", 5), ("420", 3)])
def test_carried_matches_jax_v2(sampling, bit_base):
    blocks = component_blocks(40 + bit_base, 12, sampling)
    prev = np.array([3, -7, 100], np.int32)
    cap_words, lw = 1024, 24
    ref = pack_carried_ref(
        *blocks, JAX_LUTS, jnp.asarray(prev), jnp.int32(bit_base), cap_words=cap_words,
        local_words=lw, sampling=sampling,
    )
    words, total, new_dc, max_bb = E.entropy_pack_carried(
        *to_torch(blocks), LUTS, torch.from_numpy(prev),
        torch.tensor(bit_base), cap_words, local_words=lw, sampling=sampling,
    )
    total_ref = int(np.asarray(ref[1]))
    assert total_ref <= cap_words * 32 and int(np.asarray(ref[3])) <= lw * 32
    assert int(total) == total_ref
    n = (total_ref + 31) // 32
    np.testing.assert_array_equal(u32(words)[:n], np.asarray(ref[0])[:n])
    assert not u32(words)[n:].any()
    np.testing.assert_array_equal(new_dc.numpy(), np.asarray(ref[2]))
    assert int(max_bb) == int(np.asarray(ref[3]))
