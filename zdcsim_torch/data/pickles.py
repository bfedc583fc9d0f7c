"""A reader of the reference's training pickles that needs neither pandas
nor pyarrow.

The reference's three training inputs are pickles (``pd.to_pickle``): the
log-space images as a numpy array, the conditioning and the coordinates as
pandas DataFrames. :func:`read_pickle` reads them with a restricted
:class:`pickle.Unpickler`: its ``find_class`` maps an allowlist of the
globals those files name to small stand-ins defined here, and refuses any
other global with an error that names ``module.name`` and the file. No
global of the file is ever looked up, so reading a file runs no code it
names.

What it reads: a numpy array (``_frombuffer`` of protocol 5, or
``_reconstruct`` with the array's state), and a DataFrame of 2-D numpy
blocks (``BlockManager`` as pandas >= 2.1 writes it, a call on
``(blocks, axes)``, or older pandas' ``__setstate__`` layout), whose column
labels are an Arrow string array (pandas 3's default: the offsets and data
buffers are decoded here), an object ndarray (pandas 2.x, and pandas 3
under ``future.infer_string=False``) or a ``RangeIndex``. Files written
under numpy 1.x name ``numpy.core.*`` in place of ``numpy._core.*``; both
are mapped. A DataFrame comes back as an ordered ``{column: 1-D numpy
array}`` with the stored dtypes; the row index is dropped (the training
pipeline reads rows by position).
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, List, Union

import numpy as np


# -- numpy ---------------------------------------------------------------------


def _frombuffer(buf, dtype, shape, order):
    """numpy's own ``numpy._core.numeric._frombuffer``."""
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order=order)


def _reconstruct(subtype, shape, dtype):
    """``numpy._core.multiarray._reconstruct`` for plain ndarrays only; the
    array's ``__setstate__`` (BUILD) then fills it."""
    if subtype is not np.ndarray:
        raise pickle.UnpicklingError(f"_reconstruct of {subtype!r} refused: ndarray only")
    return np.ndarray.__new__(np.ndarray, shape, dtype)


# -- pyarrow: a string array's buffers -----------------------------------------

_ARROW_OFFSETS = {"string": np.int32, "utf8": np.int32, "large_string": np.int64,
                  "large_utf8": np.int64}


def _type_for_alias(alias):
    if alias not in _ARROW_OFFSETS:
        raise pickle.UnpicklingError(f"pyarrow type {alias!r} refused: string types only")
    return alias


def _py_buffer(data):
    return bytes(data)


def _restore_array(data):
    """``pyarrow.lib._restore_array`` of a string array: ``(type, length,
    null_count, offset, [validity, offsets, data], children, dictionary)``
    -> an object ndarray of ``str`` (``None`` where the validity bit is 0)."""
    alias, length, null_count, offset, buffers = data[:5]
    validity, offsets, chars = buffers
    off = np.frombuffer(offsets, dtype=_ARROW_OFFSETS[alias])[offset: offset + length + 1]
    out = np.empty(length, dtype=object)
    for i in range(length):
        out[i] = chars[off[i]: off[i + 1]].decode("utf-8")
    if null_count and validity is not None:
        bits = np.unpackbits(np.frombuffer(validity, np.uint8), bitorder="little")
        out[bits[offset: offset + length] == 0] = None
    return out


# -- pandas --------------------------------------------------------------------


class _Stub:
    """A pickled pandas object held as its state: ``args`` of the call that
    made it, ``state`` of its BUILD."""

    args: tuple = ()
    state: Any = None

    def __init__(self, *args):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _DataFrame(_Stub):
    pass


class _BlockManager(_Stub):
    pass


class _ArrowStringArray(_Stub):
    pass


class _StringDtype(_Stub):
    pass


class _Index(_Stub):
    pass


class _RangeIndex(_Stub):
    pass


def _new_Index(cls, d):
    """``pandas.core.indexes.base._new_Index``: the labels as a numpy array."""
    if cls is _RangeIndex:
        return np.arange(d["start"], d["stop"], d["step"])
    data = d["data"]
    if isinstance(data, _ArrowStringArray):
        data = data.state["_pa_array"]
    return np.asarray(data)


def _unpickle_block(values, placement, ndim):
    return ("block", values, placement, ndim)


def _locs(placement) -> np.ndarray:
    if isinstance(placement, slice):
        return np.arange(placement.start or 0, placement.stop, placement.step or 1)
    return np.asarray(placement, np.int64).reshape(-1)


def _frame_columns(frame: _DataFrame) -> Dict[Any, np.ndarray]:
    """The ``{column: values}`` of a DataFrame's BlockManager, in column order."""
    st = frame.state if isinstance(frame.state, dict) else {}
    mgr = st.get("_mgr", st.get("_data"))
    if not isinstance(mgr, _BlockManager):
        raise pickle.UnpicklingError("a DataFrame without a BlockManager")
    if mgr.args:  # pandas >= 2.1: BlockManager(blocks, axes)
        blocks, axes = mgr.args[:2]
        blocks = [(b[1], b[2]) for b in blocks]
    elif isinstance(mgr.state, tuple) and len(mgr.state) >= 4 and "0.14.1" in mgr.state[3]:
        st = mgr.state[3]["0.14.1"]  # older pandas: the __setstate__ layout
        axes = st["axes"]
        blocks = [(b["values"], b["mgr_locs"]) for b in st["blocks"]]
    else:
        raise pickle.UnpicklingError("a BlockManager in a layout this reader does not know")
    names = list(np.asarray(axes[0]))
    cols: List[Any] = [None] * len(names)
    for values, placement in blocks:
        values = np.asarray(values)
        if values.ndim == 1:
            values = values[None]
        for row, loc in zip(values, _locs(placement)):
            cols[loc] = row
    return {name: col for name, col in zip(names, cols)}


# -- the allowlist -------------------------------------------------------------

_ALLOWED = {
    ("numpy._core.numeric", "_frombuffer"): _frombuffer,
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy", "dtype"): np.dtype,
    ("numpy", "ndarray"): np.ndarray,
    ("builtins", "slice"): slice,
    ("builtins", "bytearray"): bytearray,  # an array's buffer below protocol 5
    ("pandas", "DataFrame"): _DataFrame,
    ("pandas.core.frame", "DataFrame"): _DataFrame,
    ("pandas", "Index"): _Index,
    ("pandas.core.indexes.base", "Index"): _Index,
    ("pandas", "RangeIndex"): _RangeIndex,
    ("pandas.core.indexes.range", "RangeIndex"): _RangeIndex,
    ("pandas", "StringDtype"): _StringDtype,
    ("pandas.core.indexes.base", "_new_Index"): _new_Index,
    ("pandas.core.internals.managers", "BlockManager"): _BlockManager,
    ("pandas._libs.internals", "_unpickle_block"): _unpickle_block,
    ("pandas.arrays", "ArrowStringArray"): _ArrowStringArray,
    ("pyarrow.lib", "_restore_array"): _restore_array,
    ("pyarrow.lib", "py_buffer"): _py_buffer,
    ("pyarrow.lib", "type_for_alias"): _type_for_alias,
}
# numpy 1.x writes numpy.core.* where numpy 2.x writes numpy._core.*
_ALLOWED.update({("numpy.core" + m[len("numpy._core"):], n): f
                 for (m, n), f in list(_ALLOWED.items()) if m.startswith("numpy._core")})


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, path: str):
        super().__init__(f)
        self.path = path

    def find_class(self, module, name):
        try:
            return _ALLOWED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"{self.path}: global {module}.{name} refused (not a global of the reference's "
                f"training pickles)") from None


def read_pickle(path: str) -> Union[np.ndarray, Dict[Any, np.ndarray]]:
    """Read one of the reference's training pickles without pandas: a numpy
    array as it was stored, a DataFrame as an ordered ``{column: 1-D
    array}`` with the stored dtypes."""
    with open(path, "rb") as f:
        obj = _Unpickler(io.BytesIO(f.read()), path).load()
    if isinstance(obj, _DataFrame):
        return _frame_columns(obj)
    if isinstance(obj, np.ndarray):
        return obj
    raise pickle.UnpicklingError(f"{path}: holds a {type(obj).__name__}, not an array or a "
                                 f"DataFrame")
