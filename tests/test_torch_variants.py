"""The knock-out variants that `ops/cuda/variants.py` times on the card are
made by text substitution in the kernels' sources and the shared headers
they include: each substitution must still find its text, or the script
would time the shipped kernel under a variant's name. Every header under
`csrc/` is listed in `build._HEADERS`, so that an edit to it rebuilds the
kernels and reaches the variants' directories."""

import os

import pytest

from generative_recommenders_tpu_torch.data import native_reader
from generative_recommenders_tpu_torch.ops.cuda import build, variants


@pytest.mark.parametrize("kernel,label,phases", variants.VARIANTS, ids=[f"{k}: {n}" for k, n, _ in variants.VARIANTS])
def test_variant_sources_apply(kernel, label, phases):
    shipped = variants.shipped_sources(kernel)
    assert set(shipped) == {build.KERNEL_SOURCES[kernel], *build._HEADERS}
    sources = variants.variant_source(kernel, phases)
    assert (sources == shipped) == (not phases)
    # one extern "C" entry point, as the shipped source: the wrapper loads it by name
    assert sources[build.KERNEL_SOURCES[kernel]].count(f'extern "C" int {kernel}(') == 1


def test_a_stale_substitution_raises():
    with pytest.raises(ValueError, match="no longer holds"):
        variants._sub("text that no kernel source holds", "")({"k.cu": "some source"}, "k.cu")


def test_every_header_is_listed():
    """Every file under `csrc/` is a listed header, a kernel source or the
    native csv reader's host source (built with g++ by
    `data/native_reader.py`, not by `build`)."""
    headers = {f for f in os.listdir(build.CSRC_DIR) if f.endswith(".cuh")}
    assert headers == set(build._HEADERS)
    host = {os.path.basename(native_reader._SRC)}
    assert os.path.dirname(native_reader._SRC) == build.CSRC_DIR
    assert set(os.listdir(build.CSRC_DIR)) == headers | set(build.KERNEL_SOURCES.values()) | host
