"""The phase edits of ``esn_tpu_torch/tools/kernel_phases.py`` against the
kernel sources, on the CPU.

Each phase knocks one piece out of a copy of a kernel's source by text
edits; an edit that no longer occurs, or occurs more than once (and would
knock a phase out of two places), would time something else. The tool
raises on either; these tests find it without a card.
"""
import pytest

from esn_tpu_torch.ops.kernels import _build
from esn_tpu_torch.tools import kernel_phases as KP

CASES = [(kernel, phase) for kernel, (_, phases) in KP.PHASES.items()
         for phase in phases]


@pytest.mark.parametrize("kernel, phase", CASES,
                         ids=[f"{k}-{p}" for k, p in CASES])
def test_each_edit_occurs_exactly_once(kernel, phase):
    src, phases = KP.PHASES[kernel]
    text = (_build.SRC_DIR / src).read_text()
    edited = text
    for old, new in phases[phase]:
        assert edited.count(old) == 1, (src, old)
        edited = edited.replace(old, new)
    assert KP.edit(text, phases[phase], phase) == edited != text


def test_edit_refuses_a_repeated_or_missing_text():
    with pytest.raises(RuntimeError, match="occurs 2 times"):
        KP.edit("a; a;", [("a;", "")], "repeated")
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        KP.edit("a;", [("b;", "")], "missing")


def test_every_kernel_has_a_source_and_phases():
    for kernel, (src, phases) in KP.PHASES.items():
        assert (_build.SRC_DIR / src).is_file() and phases, kernel
