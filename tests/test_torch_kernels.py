"""The torch port's kernels against the JAX package's Pallas kernel and
against their own plain versions.

The plain pack runs against ``pack_blocks_aligned_pallas(interpret=True)``
on the symbol streams of tests/unit/test_pallas_kernels.py. The host shim
(csrc/host_shim.cpp, built with g++) runs the CUDA kernels' own per-pair
and per-block bodies against the plain versions; ``pack_merge``'s shim runs
each block's pairs in order with a running sum, the chain that the kernel's
warp scan reproduces. Everything is integer: the tolerance is zero.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_stitch_tpu.ops import jpeg_entropy_device as J
from image_stitch_tpu.ops.pallas_kernels import pack_blocks_aligned_pallas
from image_stitch_tpu_torch._build import load_host_shim
from image_stitch_tpu_torch.ops import kernels as K
from tests.utils.torch_port import u32

torch.set_num_threads(1)


def random_streams(nb, n_sym, lw, seed, clamp=True):
    """The symbol streams of tests/unit/test_pallas_kernels.py: ~30%
    zero-length slots, codes masked to their lengths, a random start
    alignment; with ``clamp``, blocks stay within the lw*32-bit budget."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 17, size=(nb, n_sym)).astype(np.int32)
    lens[rng.random(lens.shape) < 0.3] = 0
    mask = ((1 << lens.astype(np.int64)) - 1).astype(np.uint32)
    codes = rng.integers(0, 1 << 16, size=(nb, n_sym)).astype(np.uint32) & mask
    if clamp:
        over = lens.sum(axis=1) > lw * 32
        lens[over] = np.minimum(lens[over], 4)
    starts = (
        np.cumsum(np.concatenate([[0], lens.sum(axis=1)[:-1]])).astype(np.int32)
        + int(rng.integers(0, 32))
    )
    return codes, lens, starts


def torch_streams(codes, lens, starts):
    return (torch.from_numpy(codes.astype(np.int64).astype(np.int32)),
            torch.from_numpy(lens), torch.from_numpy(starts))


PACK_CASES = [(596, 43, 12, 0), (262, 41, 9, 1), (694, 3, 8, 2), (10, 11, 13, 3),
              (512, 65, 16, 4)]


@pytest.mark.parametrize("nb,n_sym,lw,seed", PACK_CASES)
def test_plain_pack_matches_pallas_interpret(nb, n_sym, lw, seed):
    codes, lens, starts = random_streams(nb, n_sym, lw, seed)
    ref = np.asarray(pack_blocks_aligned_pallas(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(starts), lw, interpret=True
    ))
    got = K.pack_blocks_aligned_plain(*torch_streams(codes, lens, starts), lw)
    assert got.shape == (nb, lw + 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(u32(got), ref.T)


def test_plain_pack_matches_xla_on_over_budget_blocks():
    """Blocks past the budget clip their word indices exactly as the
    reference does (their words are discarded, but they still agree)."""
    codes, lens, starts = random_streams(300, 65, 4, 5, clamp=False)
    ref = np.asarray(J._pack_blocks_aligned(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(starts), 4, transpose=True
    ))
    got = K.pack_blocks_aligned_plain(*torch_streams(codes, lens, starts), 4)
    np.testing.assert_array_equal(u32(got), ref)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data_as(ctypes.c_void_p).value


# (nb, n_sym, local_words, seed, clamp): PACK_CASES (odd and even slot
# counts, AW 10 to 18), the encoder's AW 14 and 26 at 65 slots, and blocks
# over a 4-word budget, whose clipped words overlap the next block's.
MERGE_CASES = [c + (True,) for c in PACK_CASES] + [
    (2000, 65, 12, 8, True), (1500, 65, 24, 8, True), (300, 65, 4, 5, False),
]


@pytest.mark.parametrize("nb,n_sym,lw,seed,clamp", MERGE_CASES)
def test_kernel_bodies_match_plain(nb, n_sym, lw, seed, clamp):
    """csrc/pack_merge.cuh, compiled by g++ into the serial host shim,
    against ``pack_merge_plain`` (the plain pack, then the plain merge):
    at a word count that holds the whole stream and at one that drops the
    last three words."""
    shim = load_host_shim()
    codes, lens, starts = random_streams(nb, n_sym, lw, seed, clamp=clamp)
    c, ln, s = torch_streams(codes, lens, starts)
    c_np, l_np, s_np = (np.ascontiguousarray(t.numpy()) for t in (c, ln, s))
    assert (lens == 0).any() and starts[0] % 32
    full = int(starts[-1] + lens[-1].sum()) // 32 + 1 + (lw + 2)
    for n_words in (full, full - (lw + 2) - 3):
        dense = np.zeros(n_words, np.int32)
        shim.pack_merge_host(_ptr(c_np), _ptr(l_np), _ptr(s_np), _ptr(dense),
                             nb, n_sym, lw + 2, n_words)
        plain = K.pack_merge_plain(c, ln, s, lw, n_words)
        np.testing.assert_array_equal(dense, plain.numpy())
    if not clamp:
        assert (lens.sum(axis=1) > lw * 32).any()


def test_wrappers_check_inputs_and_count_only_launches():
    codes, lens, starts = random_streams(20, 65, 12, 6)
    c, ln, s = torch_streams(codes, lens, starts)
    before = K.pack_merge.launches
    dense = K.pack_merge(c, ln, s, 12, 100)
    # The CPU path runs the plain version and launches nothing.
    assert K.pack_merge.launches == before
    assert torch.equal(dense, K.pack_merge_plain(c, ln, s, 12, 100))
    with pytest.raises(TypeError):
        K.pack_merge(c.to(torch.int64), ln, s, 12, 100)
    with pytest.raises(ValueError):
        K.pack_merge(c[:, ::2], ln[:, ::2], s, 12, 100)
    with pytest.raises(ValueError):
        K.pack_merge(c, ln, s[:-1], 12, 100)
    with pytest.raises(ValueError):
        K.pack_merge(c, ln, s, 40, 100)
    with pytest.raises(ValueError):
        K.pack_merge(c, ln, s, 12, -1)
    with pytest.raises(ValueError):
        K.pack_merge(c.t(), ln.t(), s, 12, 100)
