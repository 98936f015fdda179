"""The WKV backward's TF32 helpers are a copy of the flash kernels' (so that
the build's hash of ``rwkv_scan/csrc/`` covers them): the operand split
and the ``mma.sync`` wrapper of
``src/repro_torch/kernels/rwkv_scan/csrc/wkv_backward_chunk.cuh`` must
keep the text of ``flash_attention/csrc/mma_tf32.cuh``'s, comments and
whitespace aside.  A fix to one copy that misses the other fails here."""
import pathlib
import re

import pytest

KERNELS = pathlib.Path(__file__).resolve().parents[1] / "src" / \
    "repro_torch" / "kernels"
WKV = KERNELS / "rwkv_scan" / "csrc" / "wkv_backward_chunk.cuh"
FLASH = KERNELS / "flash_attention" / "csrc" / "mma_tf32.cuh"


def _code(path: pathlib.Path) -> str:
    """The file's text without comments, each run of whitespace one
    space."""
    text = re.sub(r"/\*.*?\*/", " ", path.read_text(), flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return re.sub(r"\s+", " ", text)


def _braced(code: str, start: int) -> str:
    """From ``start`` to the brace that closes the first brace after it."""
    i = code.index("{", start)
    depth = 0
    for j in range(i, len(code)):
        depth += {"{": 1, "}": -1}.get(code[j], 0)
        if depth == 0:
            return code[start:j + 1]
    raise ValueError("unbalanced braces")


def _function(code: str, head: str) -> str:
    """The definition that starts with ``head`` (one match)."""
    hits = [m.start() for m in re.finditer(re.escape(head), code)]
    assert len(hits) == 1, (head, len(hits))
    return _braced(code, hits[0])


def _body(fn: str) -> str:
    return fn[fn.index("{") + 1:fn.rindex("}")].strip()


@pytest.mark.parametrize("head", [
    "struct Op {",
    "__device__ __forceinline__ void mma(float (&d)[4],",
    "__device__ __forceinline__ float f32(__nv_bfloat16 x) {",
    "__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {"])
def test_helper_text_equal(head):
    assert _function(_code(WKV), head) == _function(_code(FLASH), head)


def test_split_equals_the_split_branch():
    """``split`` (WKV) is the ``SPLIT`` branch of ``op<SPLIT>`` (flash):
    hi rounded to TF32 (nearest, ties away), lo the rest."""
    wkv = _body(_function(_code(WKV), "__device__ __forceinline__ Op split("))
    flash = _function(_code(FLASH), "__device__ __forceinline__ Op op(")
    branch = _body(_braced(flash, flash.index("if (SPLIT)")))
    assert wkv == branch
    assert "0xffffe000u" in wkv and "+ 0x1000u" in wkv


def test_mma_is_m16n8k8_tf32():
    fn = _function(_code(WKV),
                   "__device__ __forceinline__ void mma(float (&d)[4],")
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in fn
