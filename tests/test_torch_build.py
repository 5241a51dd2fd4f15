"""The ctypes signatures in capital_tpu_torch.ops._build against the C entry
points they call.

ctypes passes arguments by the declared list and checks nothing against the
library, so a list that drifts from its `extern "C"` definition shifts every
later argument (the stream pointer among them) without an error.  These tests
parse each definition from its source and need no compiler.
"""

import ctypes
import re

import pytest

from capital_tpu_torch.ops import _build

_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "double": ctypes.c_double}


def _c_params(src: str, name: str) -> list[str]:
    text = (_build.CSRC / src).read_text()
    m = re.search(r'extern\s+"C"\s+int\s+' + re.escape(name) + r"\s*\(([^)]*)\)", text)
    assert m, f"{name} is not defined in {src}"
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def _ctype(param: str) -> str:
    if "*" in param:
        return "pointer"
    base = re.sub(r"\s*\b\w+$", "", param.replace("const ", ""))
    return _C_TYPES[base].__name__


def _declared(t) -> str:
    return "pointer" if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer) else t.__name__


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_c_definition(name):
    src, argtypes = _build.SIGNATURES[name]
    assert src in _build.SOURCES
    got = [_declared(t) for t in argtypes]
    want = [_ctype(p) for p in _c_params(src, name)]
    assert got == want, f"{name}: ctypes {got} vs C {want}"


def test_every_entry_point_is_declared():
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        for name in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(', text):
            assert _build.SIGNATURES.get(name, (None,))[0] == src, f"{src}: {name} has no signature"


@pytest.mark.parametrize("rows,cols", [(1, 1), (5, 17), (300, 200), (8192, 8192)])
def test_x3_workspace_matches_the_source_layout(rows, cols):
    """The x3 route's workspace: the wrappers size it (`hopper._image_elems`)
    and the C side lays the images out in it (x3_tiles.cuh `image_ld`,
    `image_elems`); both round an image row up to 16 bytes of bf16."""
    from capital_tpu_torch.ops import hopper

    text = (_build.CSRC / "x3_tiles.cuh").read_text()
    assert "return (cols + 7) / 8 * 8;" in text
    assert "return 2 * rows * image_ld(cols);" in text
    assert hopper._image_elems(rows, cols) == 2 * rows * ((cols + 7) // 8 * 8)
