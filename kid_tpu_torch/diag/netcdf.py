"""Minimal pure-NumPy classic NetCDF-3 (CDF-1/CDF-2) writer (a copy of
``kid_tpu/diag/netcdf.py``: the same bytes for the same registry).

The reference's save_dg streams feed KiD's netCDF output
(mphys_thompson09n.f90:155-192, 248-308).  Classic format only: fixed
dimensions, NC_FLOAT/NC_DOUBLE/NC_INT variables, text attributes, readable
by scipy.io.netcdf_file, xarray's scipy engine and ncdump.

Format per the NetCDF classic spec (header: magic, numrecs, dim_list,
gatt_list, var_list; data: 4-byte-aligned big-endian blocks).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

NC_DIMENSION = 0x0A
NC_VARIABLE = 0x0B
NC_ATTRIBUTE = 0x0C
NC_CHAR, NC_INT, NC_FLOAT, NC_DOUBLE = 2, 4, 5, 6

_DTYPES = {
    np.dtype(">i4"): (NC_INT, 4),
    np.dtype(">f4"): (NC_FLOAT, 4),
    np.dtype(">f8"): (NC_DOUBLE, 8),
}


def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * ((4 - len(b) % 4) % 4)


def _name(s: str) -> bytes:
    e = s.encode()
    return struct.pack(">I", len(e)) + _pad4(e)


def _text_att(name: str, text: str) -> bytes:
    e = text.encode()
    return (_name(name) + struct.pack(">I", NC_CHAR)
            + struct.pack(">I", len(e)) + _pad4(e))


def _att_list(atts: Dict[str, str]) -> bytes:
    if not atts:
        return struct.pack(">II", 0, 0)
    return (struct.pack(">II", NC_ATTRIBUTE, len(atts))
            + b"".join(_text_att(k, v) for k, v in atts.items()))


def _to_be(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return a.astype(">f8" if a.dtype.itemsize == 8 else ">f4")
    if a.dtype.kind in "iub":
        return a.astype(">i4")
    raise TypeError(f"unsupported dtype {a.dtype}")


def write_netcdf(path: str,
                 variables: Dict[str, Tuple[np.ndarray, List[str],
                                            Dict[str, str]]],
                 global_atts: Dict[str, str] | None = None) -> None:
    """Write ``{name: (array, dim_names, attributes)}`` as classic NetCDF.

    Dimension names are shared across variables; a dimension name used
    with two different lengths gets a disambiguated alias (``z2`` ...).
    CDF-2 (64-bit offsets) is emitted when the file would exceed 2 GiB.
    """
    global_atts = dict(global_atts or {})
    # resolve shared dimensions
    dims: List[Tuple[str, int]] = []
    dimid: Dict[Tuple[str, int], int] = {}
    var_rows = []
    for vname, (arr, dim_names, atts) in variables.items():
        a = _to_be(np.asarray(arr))
        if len(dim_names) != a.ndim:
            raise ValueError(f"{vname}: {len(dim_names)} dim names for "
                             f"rank-{a.ndim} array")
        ids = []
        for dn, ln in zip(dim_names, a.shape):
            key = (dn, ln)
            if key not in dimid:
                used = {d[0] for d in dims}
                nm, k = dn, 2
                while nm in used:                 # same name, new length
                    nm = f"{dn}{k}"; k += 1
                dimid[key] = len(dims)
                dims.append((nm, ln))
            ids.append(dimid[key])
        var_rows.append((vname, a, ids, dict(atts)))

    big = sum(v[1].nbytes for v in var_rows) > (1 << 31) - 1
    off_fmt = ">Q" if big else ">I"
    magic = b"CDF\x02" if big else b"CDF\x01"

    dim_list = (struct.pack(">II", NC_DIMENSION, len(dims))
                + b"".join(_name(n) + struct.pack(">I", ln)
                           for n, ln in dims)) if dims else \
        struct.pack(">II", 0, 0)
    gatts = _att_list(global_atts)

    # two passes: header size depends only on static layout
    def var_entry(vname, a, ids, atts, begin):
        nc_type, _ = _DTYPES[a.dtype]
        vsize = (a.nbytes + 3) // 4 * 4
        return (_name(vname)
                + struct.pack(">I", len(ids))
                + b"".join(struct.pack(">I", i) for i in ids)
                + _att_list(atts)
                + struct.pack(">I", nc_type)
                + struct.pack(">I", min(vsize, (1 << 32) - 1))
                + struct.pack(off_fmt, begin))

    # compute header length with dummy offsets
    dummy = (struct.pack(">II", NC_VARIABLE, len(var_rows))
             + b"".join(var_entry(v, a, ids, atts, 0)
                        for v, a, ids, atts in var_rows)) \
        if var_rows else struct.pack(">II", 0, 0)
    header_len = len(magic) + 4 + len(dim_list) + len(gatts) + len(dummy)

    begins = []
    off = (header_len + 3) // 4 * 4
    for _, a, _, _ in var_rows:
        begins.append(off)
        off += (a.nbytes + 3) // 4 * 4

    var_list = (struct.pack(">II", NC_VARIABLE, len(var_rows))
                + b"".join(var_entry(v, a, ids, atts, b)
                           for (v, a, ids, atts), b
                           in zip(var_rows, begins))) \
        if var_rows else struct.pack(">II", 0, 0)

    with open(path, "wb") as f:
        f.write(magic + struct.pack(">I", 0)        # numrecs = 0 (fixed)
                + dim_list + gatts + var_list)
        f.write(b"\x00" * (begins[0] - f.tell() if var_rows else 0))
        for (_, a, _, _), b in zip(var_rows, begins):
            f.write(_pad4(a.tobytes()))


def registry_to_netcdf(reg, path: str) -> None:
    """Persist a DiagRegistry as classic NetCDF (save_dg's sink)."""
    variables = {}
    gatts = {"source": "kid_tpu", "conventions": "KiD save_dg streams"}
    for name in reg.names():
        s = reg._streams[name]
        if s.data.dtype.kind == "U":          # meta strings -> attributes
            gatts[name] = ",".join(map(str, s.data.ravel()))
            continue
        dims = [d for d in s.dims.split(",") if d] or \
            [f"d{i}" for i in range(s.data.ndim)]
        if len(dims) != s.data.ndim:          # registry dims are advisory
            dims = [f"{name}_d{i}" for i in range(s.data.ndim)]
        variables[name] = (s.data, dims, {"units": s.units} if s.units
                           else {})
    write_netcdf(path, variables, gatts)
