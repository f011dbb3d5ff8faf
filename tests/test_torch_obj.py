"""The port's OBJ loader against the reference's (fault F5).

``pathtracer_tpu.io.obj.load_obj`` parses through the reference's native
library wherever it is built (``pathtracer_tpu/native/src/ptnative.cpp``);
the port's ``load_obj`` parses through its own copy of that library and
``load_obj_python`` is its plain twin. All three must agree: vertices bit
for bit (float32 words, so NaN and -0.0 count), faces equal. The one
standing deviation is the line length: the reference's library cuts a line
into pieces of 4,095 bytes, the port reads it whole, as the reference's
pure-Python parser does (``test_long_lines_are_read_whole``).

Tests that need the reference's native library skip, with the reason, where
``pathtracer_tpu.native.bindings.available()`` is False.
"""
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pathtracer_tpu.io import obj as jobj
from pathtracer_tpu.native import bindings as jbindings
from pathtracer_tpu_torch.io import obj as tobj
from pathtracer_tpu_torch.scene import bunny as tbunny

TRI = "v 0 0 0\nv 1 0 0\nv 0 1 0\n"

# (OBJ text, vertices, faces as the reference's native library reads them)
CASES = {
    "tab after the tag": ("v\t0 0 0\nv\t1 0 0\nv\t0 1 0\nf\t1 2 3\n",
                          3, [[0, 1, 2]]),
    "trailing comment": (TRI + "f 1 2 3 # c\n", 3, [[0, 1, 2]]),
    "bad index token": (TRI + "v 1 1 0\nf 1 2 x 3\n", 4, []),
    "empty index": (TRI + "f 1 /2 2 3\n", 3, []),
    "two numbers": (TRI + "v 0 0\nf 1 2 3\n", 3, [[0, 1, 2]]),
    "a word for a number": (TRI + "v 1 2 abc\nf -3 -2 -1\n", 3,
                            [[0, 1, 2]]),
    "hex float": ("v 0x1p3 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n", 3,
                  [[0, 1, 2]]),
    "CRLF": (TRI.replace("\n", "\r\n") + "f 1 2 3\r\n", 3, [[0, 1, 2]]),
    "negative, plus and zero indices": (TRI + "v 1 1 0\nf -4 +2 0 -1\n", 4,
                                        [[0, 1, 4], [0, 4, 3]]),
    "v//vn and v/vt/vn": (TRI + "v 1 1 0\nf 1//1 2/1/1 4/2/2 3//9\n", 4,
                          [[0, 1, 3], [0, 3, 2]]),
    "four numbers": ("v 0 0 0 1\nv 1 0 0 1\nv 0 1 0 1\nf 1 2 3\n", 3,
                     [[0, 1, 2]]),
    "nan and inf": ("v nan -inf infinity\nv -nan 1e400 -0\nv 0 1 0\n"
                    "f 1 2 3\n", 3, [[0, 1, 2]]),
    "no final newline": (TRI + "f 1 2 3", 3, [[0, 1, 2]]),
    "fp32 rounding": ("v 0.1 3.4028236e38 1e-46\nv 16777217 1 0\n"
                      "v 0 1 0\nf 1 2 3\n", 3, [[0, 1, 2]]),
    "scanf's number grammar": ("v 1-2-3\nv 1 2 3abc\nv 1e 2 3\n"
                               "v 1.5.6 2\nv infin 1 2 3\nv nan(1) 2 3\n"
                               "v 0x 1 2 3\nf 1 2 3\n", 4, [[0, 1, 2]]),
    "leading whitespace": (TRI + " v 1 1 0\n f 1 2 3\nf 1 2 3\n", 3,
                           [[0, 1, 2]]),
    "indices past a C long": (TRI + "f 1 2 " + "9" * 30 + " -" + "0" * 30
                              + "3\n", 3, [[0, 1, -2], [0, -2, 0]]),
}


@pytest.fixture(scope="module")
def jax_native():
    """The reference's ``load_obj`` as it runs with its native library."""
    if not jbindings.available():
        pytest.skip("the reference's native library (pathtracer_tpu/"
                    "native) is not built and cannot be built here")
    return jobj.load_obj


def _write(tmp_path, text, name="t.obj"):
    path = tmp_path / name
    path.write_bytes(text.encode() if isinstance(text, str) else text)
    return str(path)


def _assert_same(a, b):
    """Vertices equal as float32 words, faces equal."""
    assert a[0].dtype == b[0].dtype == np.float32
    assert a[1].dtype == b[1].dtype == np.int32
    assert a[0].shape == b[0].shape and a[1].shape == b[1].shape
    np.testing.assert_array_equal(a[0].view(np.uint32), b[0].view(np.uint32))
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("case", list(CASES))
def test_load_obj_matches_reference(case, tmp_path, jax_native):
    """The port's ``load_obj`` (native) on each case of F5's table."""
    text, n_verts, faces = CASES[case]
    path = _write(tmp_path, text)
    got = tobj.load_obj(path)
    _assert_same(got, jax_native(path))
    assert got[0].shape == (n_verts, 3)
    np.testing.assert_array_equal(got[1], np.asarray(faces,
                                                     np.int32).reshape(-1, 3))


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_native(case, tmp_path):
    """``load_obj_python`` on each case, against the port's library."""
    path = _write(tmp_path, CASES[case][0])
    _assert_same(tobj.load_obj_python(path), tobj.load_obj(path))


def test_values_of_the_number_grammar(tmp_path):
    """What sscanf's grammar makes of the odd records: hex, a collected but
    unconverted exponent, a second point, signed NaN, fp32 rounding."""
    path = _write(tmp_path, CASES["scanf's number grammar"][0])
    verts, _ = tobj.load_obj(path)
    np.testing.assert_array_equal(verts, np.float32(
        [[1, -2, -3], [1, 2, 3], [1, 2, 3], [1.5, 0.6, 2]]))
    verts, _ = tobj.load_obj(_write(tmp_path, CASES["nan and inf"][0]))
    words = verts.view(np.uint32)
    assert words[0, 0] == 0x7FC00000 and words[1, 0] == 0xFFC00000
    assert verts[0, 1] == -np.inf and verts[0, 2] == np.inf
    assert verts[1, 1] == np.inf and words[1, 2] == 0x80000000
    verts, _ = tobj.load_obj(_write(tmp_path, CASES["fp32 rounding"][0]))
    np.testing.assert_array_equal(
        verts[:2], np.float32([[0.1, np.inf, 0.0], [16777216, 1, 0]]))


def test_bunny_asset(jax_native):
    """The vendored bunny: 1,817 vertices, 3,616 faces, the same in all
    three parsers."""
    got = tobj.load_obj(tbunny.ASSET_OBJ)
    assert got[0].shape == (1817, 3) and got[1].shape == (3616, 3)
    _assert_same(got, jax_native(tbunny.ASSET_OBJ))
    _assert_same(tobj.load_obj_python(tbunny.ASSET_OBJ), got)


def test_long_lines_are_read_whole(tmp_path, jax_native):
    """The standing deviation. A face of 2,400 one-digit indices is 4,802
    bytes: the reference's library reads its first 4,095 (2,047 indices,
    2,045 triangles) and drops the rest; the port reads it whole (2,398
    triangles), as the reference's pure-Python parser does. A vertex behind
    4,095 bytes of padding is dropped by the reference's library."""
    face = "f " + " ".join(str(1 + i % 3) for i in range(2400)) + "\n"
    path = _write(tmp_path, TRI + face)
    assert jax_native(path)[1].shape == (2045, 3)
    got = tobj.load_obj(path)
    assert got[1].shape == (2398, 3)
    _assert_same(tobj.load_obj_python(path), got)
    _assert_same(jobj.load_obj_python(path), got)

    path = _write(tmp_path, "v" + " " * 5000 + "1 2 3\n" + TRI, "v.obj")
    assert jax_native(path)[0].shape == (3, 3)
    got = tobj.load_obj(path)
    np.testing.assert_array_equal(got[0][0], np.float32([1, 2, 3]))
    assert got[0].shape == (4, 3)
    _assert_same(tobj.load_obj_python(path), got)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tobj.load_obj(str(tmp_path / "none.obj"))


# -- a grammar of OBJ files ---------------------------------------------------

_SEP = st.sampled_from([" ", "\t", "  ", " \t", "\t\t"])
_NUMBER = st.one_of(
    st.floats(allow_nan=False, allow_infinity=False, width=32).map(repr),
    st.floats(allow_nan=False, allow_infinity=False).map(repr),
    st.integers(-10 ** 6, 10 ** 6).map(str),
    st.floats(-1e6, 1e6).map(float.hex),
    st.sampled_from(["inf", "-inf", "+infinity", "INF", "nan", "-nan", "NaN",
                     "0x1p3", "-0x1.8p-2", "0X.8P1", "1e", "1e+", "-0",
                     ".5", "5.", "1.5.6", "1-2", "0x", "nan(1)", "infin",
                     "3abc", "1e400", "1e-50", "0x1p-149", "0x1p-150"]))
_INDEX = st.builds(
    lambda sign, i, tail: sign + str(i) + tail,
    st.sampled_from(["", "", "+", "-"]), st.integers(0, 12),
    st.sampled_from(["", "", "/1", "//2", "/1/2", "/", "abc"]))
_BAD = st.sampled_from(["x", "#", "# c", "/2", "abc", "-", "+", "#1 2"])


@st.composite
def _record(draw):
    kind = draw(st.sampled_from(["v", "v", "v", "f", "f", "f", "other"]))
    if kind == "other":
        return draw(st.sampled_from(["# comment", "vn 0 1 0", "vt 0.5 1",
                                     "", "o part", "s off", " v 1 2 3",
                                     "\tf 1 2 3", "g x"]))
    tag = kind + draw(st.sampled_from([" ", "\t"]))
    if kind == "v":   # mostly three numbers; short and long records too
        n = draw(st.sampled_from([3, 3, 3, 3, 3, 1, 2, 4]))
        toks = draw(st.lists(_NUMBER, min_size=n, max_size=n))
    else:
        toks = draw(st.lists(_INDEX, min_size=3, max_size=8))
    if draw(st.integers(0, 3)) == 0:
        toks.insert(draw(st.integers(0, len(toks))), draw(_BAD))
    seps = [draw(_SEP) for _ in toks]
    return tag + "".join(t + s for t, s in zip(toks, seps)).rstrip(" \t")


_FILE = st.builds(
    lambda lines, eol, last: eol.join(lines) + last,
    st.lists(_record(), min_size=1, max_size=24),
    st.sampled_from(["\n", "\r\n"]), st.sampled_from(["", "\n"]))


@settings(max_examples=200, derandomize=True, deadline=None,
          database=None, suppress_health_check=[HealthCheck.too_slow])
@given(text=_FILE)
def test_grammar(text, tmp_path_factory, jax_native):
    """Files from the grammar above (every line well under 4,095 bytes):
    the port's library, its twin and the reference agree."""
    path = _write(tmp_path_factory.getbasetemp(), text, "grammar.obj")
    got = tobj.load_obj(path)
    _assert_same(got, jax_native(path))
    _assert_same(tobj.load_obj_python(path), got)
