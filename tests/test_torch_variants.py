"""The kernel variant tools (``fenicsxfus_tpu_torch/tools/tile_variants.py``,
``wave_variants.py``, ``split_variants.py``) on the CPU: every change of every variant finds its
text exactly once in the committed sources, so each variant builds the
design it names. Building and timing them needs the card."""

import sys
from pathlib import Path

import pytest

TOOLS = Path(__file__).resolve().parents[1] / "fenicsxfus_tpu_torch" / "tools"
sys.path.insert(0, str(TOOLS))
import split_variants  # noqa: E402
import tile_variants  # noqa: E402
import variants  # noqa: E402
import wave_variants  # noqa: E402

CASES = [(name, changes) for name, changes in tile_variants.SOURCE_VARIANTS.items()] + [
    (name, changes) for name, changes in wave_variants.VARIANTS.items()] + [
    (name, changes) for name, changes in split_variants.SOURCE_VARIANTS.items()]


@pytest.mark.parametrize("name,changes", CASES, ids=[c[0] for c in CASES])
def test_variant_applies_to_the_sources(name, changes, tmp_path):
    root = variants.make(name, changes, base=tmp_path)
    csrc = root / "fenicsxfus_tpu_torch" / "csrc"
    for fname, old, new in changes:
        text = (csrc / fname).read_text()
        assert new in text and (old in new or old not in text)


def test_variant_text_not_once_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not once"):
        variants.make("bad", [("tile.cuh", "no such text in the tile", "")], base=tmp_path)


def test_ptxas_lines_keep_the_named_kernels():
    log = ("ptxas info    : Compiling entry function '_Z17stage_tile_kernelIfLi3ELb1EEvv' for 'sm_90a'\n"
           "ptxas info    : Used 128 registers, 57820 bytes smem\n"
           "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers\n")
    lines = variants.ptxas_lines(log, tile_variants.PTXAS)
    assert len(lines) == 1 and lines[0].endswith("Used 128 registers, 57820 bytes smem")
