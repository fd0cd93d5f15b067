"""tools/dit_block_variants.py --route bf16 edits csrc/dit_block_bf16.cu by
exact text: each edit of each variant must find its text once in the kernel
as it stands, so that the tool keeps measuring the source it names."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "dit_block_variants", ROOT / "tools" / "dit_block_variants.py")
VARIANTS_TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(VARIANTS_TOOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS_TOOL.BF16_VARIANTS))
def test_dit_block_bf16_variant_applies_to_the_kernel_source(variant):
    src = VARIANTS_TOOL.ROUTES["bf16"]["source"].read_text()
    for old, _ in VARIANTS_TOOL.BF16_VARIANTS[variant]:
        assert src.count(old) == 1, old
    VARIANTS_TOOL.edited("bf16", variant, src)
