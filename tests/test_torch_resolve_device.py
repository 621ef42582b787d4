"""The port's one device normaliser, ``ops.resolve.resolve_device``: a card
always carries its index, so that two devices the port holds compare equal
exactly when they are the same card. On the CPU, with ``torch.cuda``
patched to report cards where a test needs one."""

import pytest
import torch

from image_stitch_tpu_torch.errors import StitchError
from image_stitch_tpu_torch.ops import jpeg_entropy_device
from image_stitch_tpu_torch.ops.resolve import resolve_device
from image_stitch_tpu_torch.parallel import mesh

CUDA0, CUDA1, CPU = torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cpu")


@pytest.fixture
def cards(monkeypatch):
    """Two cards, the first current; the test may make another current."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return monkeypatch


@pytest.mark.parametrize("given,want", [
    ("cuda", CUDA0), (torch.device("cuda"), CUDA0), ("cuda:0", CUDA0), (CUDA0, CUDA0),
    ("cuda:1", CUDA1), ("cpu", CPU), (torch.device("cpu"), CPU)])
def test_a_card_carries_its_index(cards, given, want):
    got = resolve_device(given)
    assert got == want and str(got) == str(want)


def test_cuda_is_the_current_card(cards):
    cards.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_device("cuda") == CUDA1 != resolve_device("cuda:0")


def test_the_checks_are_unchanged(monkeypatch):
    assert resolve_device("cpu") == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for given in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(StitchError, match="CUDA is not available"):
            resolve_device(given)
    with pytest.raises(StitchError, match="Unsupported device: meta"):
        resolve_device("meta")


def test_the_other_normalisers_are_gone():
    assert not hasattr(jpeg_entropy_device, "canonical_device")
    assert not hasattr(mesh, "_canonical")


def jpeg_tile() -> bytes:
    import image_stitch_tpu_torch
    from tests.utils.fixtures import png_from_array, random_rgba

    return image_stitch_tpu_torch.concat_to_buffer(
        {"inputs": [png_from_array(random_rgba(16, 24, 1))], "layout": {"columns": 1},
         "outputFormat": "jpeg"}, device="cpu")


def held_devices(kind: str):
    """What each holder of a device keeps when handed the string "cuda"."""
    from image_stitch_tpu_torch.codecs.jpeg.device_decoder import DeviceJpegDecoder
    from image_stitch_tpu_torch.core import TorchStreamingConcatenator
    from image_stitch_tpu_torch.ops.composite_device import DeviceCompositor
    from image_stitch_tpu_torch.ops.device import TorchBackend
    from image_stitch_tpu_torch.ops.staging import BandStaging

    if kind == "staging":
        return [BandStaging("cuda").device]
    if kind == "compositor":
        return [DeviceCompositor("cuda").device]
    if kind == "backend":
        return [TorchBackend("cuda").device]
    if kind == "mesh":
        return mesh.Mesh([["cuda", "cuda"]]).flat()
    if kind == "decoder":
        data = jpeg_tile()
        return [DeviceJpegDecoder(data, "cuda").device, DeviceJpegDecoder(data).to("cuda").device]
    if kind == "concatenator":
        return [TorchStreamingConcatenator({"inputs": [jpeg_tile()], "outputFormat": "jpeg"},
                                           device="cuda").device]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["staging", "compositor", "backend", "mesh", "decoder",
                                  "concatenator"])
def test_every_holder_keeps_the_index(cards, kind):
    """The JPEG-tile decode's guard compares the decoder's, the staging
    ring's and the band's devices: each holder keeps "cuda" as cuda:0."""
    got = held_devices(kind)
    assert got and all(d == CUDA0 and d.index == 0 for d in got)
