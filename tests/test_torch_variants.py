"""The knock-out variants that `ops/cuda/variants.py` times on the card are
made by text substitution in the kernels' sources: each substitution must
still find its text, or the script would time the shipped kernel under a
variant's name."""

import os

import pytest

from generative_recommenders_tpu_torch.ops.cuda import build, variants


@pytest.mark.parametrize("kernel,label,phases", variants.VARIANTS, ids=[f"{k}: {n}" for k, n, _ in variants.VARIANTS])
def test_variant_sources_apply(kernel, label, phases):
    with open(os.path.join(build.CSRC_DIR, build.KERNEL_SOURCES[kernel])) as f:
        shipped = f.read()
    source = variants.variant_source(kernel, phases)
    assert (source == shipped) == (not phases)
    # one extern "C" entry point, as the shipped source: the wrapper loads it by name
    assert source.count(f'extern "C" int {kernel}(') == 1


def test_a_stale_substitution_raises():
    with pytest.raises(ValueError, match="no longer holds"):
        variants._sub("text that no kernel source holds", "")("some source")
