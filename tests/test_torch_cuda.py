"""The torch port on a CUDA device: the kernels against their plain
versions, and the slice against the host tier.

Marked ``cuda``: they need a GPU and nvcc, and skip without them. They
import no jax, so on a GPU machine without jax they run without the suite's
conftest: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import zlib

import numpy as np
import pytest
import torch

import image_stitch_tpu
import image_stitch_tpu_torch
from image_stitch_tpu.codecs.png.writer import build_png
from image_stitch_tpu.types import PngHeader
from image_stitch_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


def png_from_array(rgba: np.ndarray) -> bytes:
    h, w, _ = rgba.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    return build_png(PngHeader(width=w, height=h, bit_depth=8, color_type=6),
                     zlib.compress(raw.tobytes()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def streams(nb, n_sym, lw, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 17, size=(nb, n_sym)).astype(np.int32)
    lens[rng.random(lens.shape) < 0.3] = 0
    over = lens.sum(axis=1) > lw * 32
    lens[over] = np.minimum(lens[over], 4)
    codes = (rng.integers(0, 1 << 16, size=(nb, n_sym)) & ((1 << lens) - 1)).astype(np.int32)
    starts = (np.concatenate([[0], np.cumsum(lens.sum(axis=1))[:-1]])
              + int(rng.integers(1, 32))).astype(np.int32)
    return codes, lens, starts


@pytest.mark.parametrize("nb,n_sym,lw", [(10, 11, 13), (5000, 65, 12), (3001, 65, 24)])
def test_kernels_match_plain(cuda, nb, n_sym, lw):
    codes, lens, starts = (torch.from_numpy(a).to(cuda) for a in streams(nb, n_sym, lw, nb))
    launches = (K.pack_blocks_aligned.launches, K.merge_or.launches)
    local = K.pack_blocks_aligned(codes, lens, starts, lw)
    plain = K.pack_blocks_aligned_plain(codes, lens, starts, lw)
    n_words = int(starts[-1] + lens[-1].sum()) // 32 + 1
    dense = K.merge_or(local, starts, n_words)
    torch.cuda.synchronize()
    assert torch.equal(local, plain)
    assert torch.equal(dense, K.merge_or_plain(plain, starts, n_words))
    assert (K.pack_blocks_aligned.launches, K.merge_or.launches) == (launches[0] + 1,
                                                                     launches[1] + 1)


@pytest.mark.parametrize("ri,sampling", [(0, "444"), (1, "444"), (2, "420")])
def test_slice_matches_host(cuda, ri, sampling):
    rng = np.random.default_rng(ri)
    tiles = [png_from_array(rng.integers(0, 256, (72, 100, 4), dtype=np.uint8))
             for _ in range(4)]
    opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "jpeg",
            "jpegRestartIntervalRows": ri, "jpegSampling": sampling, "bandHeight": 48}
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = image_stitch_tpu_torch.concat_to_buffer(opts, device=cuda, counters=counters)
    assert got == image_stitch_tpu.concat_to_buffer({**opts, "backend": "numpy"})
    assert counters.bands > 0
