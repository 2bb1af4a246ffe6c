"""The design variants that kernel_designs.py builds from edited copies of
the kernel sources: every edit still finds its text, once, in the source
it edits, so that the variants a card run times (the dropped designs among
them, which live only as these edits) are the ones their labels name."""

import pytest

import kernel_designs as kd
from vae_captioning_torch import _ext

# (group, source edited, variants), as kernel_designs.main builds them
# (the ce_fwd group's edits of fused_ce.cuh built through both CE sources)
GROUPS = (("topk", "topk_lse.cu", kd.TOPK_VARIANTS),
          ("eps", "fused_z.cu", kd.EPS_VARIANTS),
          ("ce_fwd", "fused_ce.cuh", kd.CE_FWD_VARIANTS),
          ("ce_bwd_wide", "fused_ce.cu", kd.CE_BWD_WIDE_VARIANTS),
          ("writer", "fused_logits_topk.cu", kd.WRITER_VARIANTS),
          ("topk_wide", "topk_lse.cu", kd.TOPK_WIDE_VARIANTS),
          ("ce_mat_bwd", "fused_ce_mat.cu", kd.CE_MAT_BWD_VARIANTS))
# a writer variant's third entry is its plan's rows, a ce_mat_bwd one's its
# block's row tiles and whether it sums its one split: not edits
CASES = [(group, source, label, edits) for group, source, variants in GROUPS
         for label, edits, *_ in variants]


def test_groups_are_the_scripts():
    assert tuple(g for g, *_ in GROUPS) == kd.GROUPS


@pytest.mark.parametrize("group,source,label,edits", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_each_edit_applies_once(group, source, label, edits):
    """Each edit's text occurs once in the source it edits (the group's,
    or the header a three-part edit names) as the edits before it left it,
    and the edited sources differ from the sources exactly where the
    variant is not the one as built."""
    texts = {}
    for edit in edits:
        file, old, new = edit if len(edit) == 3 else (source, *edit)
        text = texts.get(file, (_ext.CSRC_DIR / file).read_text())
        assert old != new, label
        assert text.count(old) == 1, (label, old[:80])
        texts[file] = text.replace(old, new)
    changed = any(text != (_ext.CSRC_DIR / file).read_text() for file, text in texts.items())
    assert changed == bool(edits), label
    assert kd.edit_files(_ext.CSRC_DIR, edits, source) == texts, label
