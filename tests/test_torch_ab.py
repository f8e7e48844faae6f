"""Which kernels `chip_smoke.py --ab` times: those whose sources differ.

`changed_kernels(old, new, names)` compares two csrc/ directories kernel
by kernel: the .cu and every header it includes (transitively, as read in
either directory). These tests need no card: they build directories of
sources and compare them. The build lines' count of the fused select's
shuffles compiled for a diverged warp reads `cuobjdump -sass` text; its
parser is held here to a piece of such text.
"""

from __future__ import annotations

import importlib.util
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "timeopt_tpu_torch" / "csrc"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _tree(root: Path, files: dict) -> Path:
    root.mkdir(parents=True)
    for name, text in files.items():
        (root / name).write_text(text)
    return root


BASE = {
    "a.cu": '#include "h.cuh"\nint a;\n',
    "b.cu": '#include <math.h>\n#include "g.cuh"\nint b;\n',
    "c.cu": "int c;\n",
    "h.cuh": '#include "deep.cuh"\nint h;\n',
    "g.cuh": "int g;\n",
    "deep.cuh": "int deep;\n",
}


@pytest.mark.parametrize("edit,expected", [
    ({}, []),  # identical trees
    ({"c.cu": "int c2;\n"}, ["c"]),  # a .cu alone
    ({"g.cuh": "int g2;\n"}, ["b"]),  # a header one kernel includes
    ({"deep.cuh": "int deep2;\n"}, ["a"]),  # a header included by a header
    ({"a.cu": '#include "new.cuh"\nint a;\n', "new.cuh": "int n;\n"}, ["a"]),  # a header only the new tree has
    ({"unused.cuh": "int u;\n"}, []),  # a header no kernel includes
    ({"c.cu": "int c2;\n", "g.cuh": "int g2;\n"}, ["b", "c"]),
])
def test_changed_kernels_takes_what_each_build_reads(tmp_path, edit, expected):
    old = _tree(tmp_path / "old", BASE)
    new = _tree(tmp_path / "new", {**BASE, **edit})
    assert cs.changed_kernels(old, new, ["a", "b", "c"]) == expected
    assert cs.changed_kernels(new, old, ["a", "b", "c"]) == expected


def test_changed_kernels_skips_a_kernel_the_old_tree_lacks(tmp_path):
    old = _tree(tmp_path / "old", {k: v for k, v in BASE.items() if k != "c.cu"})
    new = _tree(tmp_path / "new", {**BASE, "c.cu": "int c2;\n"})
    assert cs.changed_kernels(old, new, ["a", "b", "c"]) == []


def test_kernel_sources_follow_includes():
    assert cs.kernel_sources("backward", CSRC) == {"backward.cu", "warpmat.cuh"}
    assert cs.kernel_sources("lft_select", CSRC) == {"lft_select.cu", "warpmat.cuh"}
    assert cs.kernel_sources("linesearch", CSRC) == {"linesearch.cu", "linesearch_kernel.cuh", "smallmat.cuh",
                                                     "systems.cuh"}
    assert cs.kernel_sources("linearize", CSRC) == {"linearize.cu", "dual.cuh", "systems.cuh"}
    for name in ("lft_select_generic", "lft_scan"):  # the chain both run
        assert cs.kernel_sources(name, CSRC) == {f"{name}.cu", "lft_chain.cuh", "warpmat.cuh"}


@pytest.mark.parametrize("header,expected", [
    ("warpmat.cuh", ["lft_select", "lft_select_generic", "backward", "lft_scan", "lft_query"]),
    ("lft_chain.cuh", ["lft_select_generic", "lft_scan"]),  # the LFT chain's element, compose and size rule
    ("smallmat.cuh", ["linesearch"]),
    ("linesearch_kernel.cuh", ["linesearch"]),
    ("systems.cuh", ["linesearch"]),  # the registry's dynamics, which the line search integrates
    ("dual.cuh", []),  # the Jacobian kernel's alone, which is not in the table of TPU kernels
])
def test_changed_kernels_on_this_checkout(tmp_path, header, expected):
    """A changed shared header selects exactly the kernels that include it,
    in the order of chip_smoke.py's kernel table."""
    old = tmp_path / "csrc"
    shutil.copytree(CSRC, old)
    (old / header).write_text((old / header).read_text() + "\n// an earlier version\n")
    assert cs.changed_kernels(old, CSRC, list(cs.KERNELS)) == expected
    assert cs.changed_kernels(CSRC, CSRC, list(cs.KERNELS)) == []


def test_every_kernel_has_ab_rows():
    """phase_ab times every kernel whose sources differ, and fails on one
    without rows: each kernel of the table has its row function, in the
    table's order."""
    assert list(cs.AB_ROWS) == list(cs.KERNELS)
    assert all(callable(f) for f in cs.AB_ROWS.values())


SASS = """
		Function : _ZN46_GLOBAL__N__352c886d_13_lft_select_cu_95b7c4d117lft_select_kernelIfLi15EEEvPKT_S3_S3_S3_PKdS5_S5_PS1_iiiid
        /*11050*/                   BRA.DIV UR4, 0x1a2d0 ;
        /*11060*/                   SHFL.IDX PT, R5, R9, RZ, 0x1f ;
        /*1a2d0*/                   WARPSYNC.COLLECTIVE R32, 0x1a300 ;
        /*1a2e0*/                   SHFL.IDX P0, R5, R9, RZ, 0x1f ;
        /*1a2f0*/                   ENDCOLLECTIVE ;
        /*1a300*/                   WARPSYNC.COLLECTIVE R32, 0x1a320 ;
        /*1a310*/                   ENDCOLLECTIVE ;
		Function : _ZN46_GLOBAL__N__352c886d_13_lft_select_cu_95b7c4d117lft_select_kernelIdLi5EEEvPKT_S3_S3_S3_PKdS5_S5_PS1_iiiid
        /*0100*/                   SHFL.IDX PT, R5, R9, RZ, 0x1f ;
        /*0110*/                   SHFL.BFLY PT, R6, R9, 0x1, 0x1f ;
		Function : _ZN46_GLOBAL__N__352c886d_13_lft_scan_cu_95b7c4d117lft_scan_kernelIdLi13ELi2ELb1EEEvPKT_
        /*0100*/                   WARPSYNC.COLLECTIVE R32, 0x0130 ;
        /*0110*/                   SHFL.IDX P0, R5, R9, RZ, 0x1f ;
        /*0120*/                   ENDCOLLECTIVE ;
"""


def test_select_sass_counts_collective_shuffles():
    """Each lft_select_kernel instantiation's SHFL, those between a
    WARPSYNC.COLLECTIVE and its ENDCOLLECTIVE, and the sequences; another
    kernel's function is left out."""
    assert cs.select_sass(SASS) == {
        "float 15": dict(shfl=2, collective_shfl=1, collective_sequences=2),
        "double 5": dict(shfl=2, collective_shfl=0, collective_sequences=0),
    }
