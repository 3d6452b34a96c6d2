"""easymocap camera files ``intri.yml`` / ``extri.yml``; counterpart of
``enerf_tpu/utils/camera_io.py`` (reference lib/utils/data_utils.py:623-699
``read_camera``), read without OpenCV.

The files are OpenCV ``FileStorage`` YAML. ``read_storage`` reads the
subset easymocap writes: the ``%YAML:1.0`` (or ``%YAML 1.x``) header and
``---``; a ``names`` sequence of quoted strings (or numbers); matrices as
``!!opencv-matrix`` maps of ``rows``, ``cols``, ``dt`` (``d`` or ``f``)
and ``data``, a flow list over one or more lines; plain numbers. Anything
else raises ``ValueError``. ``write_storage`` writes the same subset as
OpenCV writes it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from enerf_tpu_torch.utils.cv import rodrigues

_HEADER = re.compile(r"^%YAML(:1\.0| 1\.[0-9])$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?: (.*))?$")
_DT = {"d": np.float64, "f": np.float32}


def _number(tok: str, where: str) -> float:
    try:
        return float(tok)
    except ValueError:
        raise ValueError(f"{where}: {tok!r} is not a number") from None


def read_storage(path: str) -> Dict[str, object]:
    """The nodes of an OpenCV FileStorage YAML file of the subset above:
    each matrix as an ndarray of its ``dt``, ``names`` as a list of
    strings, a number as a float."""
    with open(path) as f:
        lines = [(i + 1, ln.rstrip("\n").rstrip()) for i, ln in enumerate(f)]
    lines = [(i, ln) for i, ln in lines if ln.strip()]
    if not lines or not _HEADER.match(lines[0][1]):
        raise ValueError(f"{path}:1: not an OpenCV YAML file (no %YAML "
                         "header)")
    k = 1
    if k < len(lines) and lines[k][1] == "---":
        k += 1
    out: Dict[str, object] = {}
    while k < len(lines):
        no, ln = lines[k]
        where = f"{path}:{no}"
        m = _KEY.match(ln)
        if not m:
            raise ValueError(f"{where}: expected 'key: value', got {ln!r}")
        key, rest = m.group(1), (m.group(2) or "").strip()
        k += 1
        if rest == "":                           # a block sequence
            items = []
            while k < len(lines) and lines[k][1].lstrip().startswith("- "):
                tok = lines[k][1].lstrip()[2:].strip()
                if len(tok) >= 2 and tok[0] == tok[-1] == '"':
                    items.append(tok[1:-1])
                else:
                    items.append(str(int(_number(tok, f"{path}:{lines[k][0]}"))))
                k += 1
            out[key] = items
        elif rest == "!!opencv-matrix":
            fields: Dict[str, str] = {}
            while k < len(lines) and lines[k][1].startswith(" "):
                fno, body = lines[k][0], lines[k][1].strip()
                fm = _KEY.match(body)
                if not fm or fm.group(1) not in ("rows", "cols", "dt",
                                                 "data"):
                    raise ValueError(f"{path}:{fno}: unexpected {body!r} in "
                                     f"matrix {key}")
                val = (fm.group(2) or "").strip()
                k += 1
                if fm.group(1) == "data":
                    while not val.endswith("]"):
                        if k >= len(lines) or not lines[k][1].startswith(" "):
                            raise ValueError(f"{path}:{fno}: unterminated "
                                             f"data of matrix {key}")
                        val += " " + lines[k][1].strip()
                        k += 1
                fields[fm.group(1)] = val
            if set(fields) != {"rows", "cols", "dt", "data"}:
                raise ValueError(f"{where}: matrix {key} lacks "
                                 f"{sorted({'rows', 'cols', 'dt', 'data'} - set(fields))}")
            if fields["dt"] not in _DT:
                raise ValueError(f"{where}: matrix {key} has dt "
                                 f"{fields['dt']!r}; only d and f are read")
            data = fields["data"]
            if not (data.startswith("[") and data.endswith("]")):
                raise ValueError(f"{where}: matrix {key} data is not a list")
            vals = [_number(t.strip(), where) for t in data[1:-1].split(",")
                    if t.strip()]
            rows, cols = int(fields["rows"]), int(fields["cols"])
            if len(vals) != rows * cols:
                raise ValueError(f"{where}: matrix {key} has {len(vals)} "
                                 f"values for {rows}x{cols}")
            out[key] = np.array(vals, np.float64).astype(
                _DT[fields["dt"]]).reshape(rows, cols)
        else:
            out[key] = _number(rest, where)
    return out


def _fmt(v: float, dt: str) -> str:
    return repr(float(np.float32(v))) if dt == "f" else repr(float(v))


def write_storage(path: str, nodes: Dict[str, object]) -> None:
    """Write ``nodes`` (``names``: a list of strings; ndarrays as
    ``!!opencv-matrix``; numbers) in OpenCV's FileStorage YAML."""
    out = ["%YAML:1.0", "---"]
    for key, val in nodes.items():
        if isinstance(val, (list, tuple)):
            out.append(f"{key}:")
            out += [f'   - "{v}"' for v in val]
        elif isinstance(val, np.ndarray):
            a = np.atleast_2d(val) if val.ndim < 2 else val
            dt = "f" if a.dtype == np.float32 else "d"
            vals = [_fmt(v, dt) for v in a.reshape(-1)]
            out += [f"{key}: !!opencv-matrix", f"   rows: {a.shape[0]}",
                    f"   cols: {a.shape[1]}", f"   dt: {dt}"]
            lines = ["   data: [ " + ", ".join(vals[:4])]
            for i in range(4, len(vals), 4):
                lines[-1] += ","
                lines.append("       " + ", ".join(vals[i:i + 4]))
            lines[-1] += " ]"
            out += lines
        else:
            out.append(f"{key}: {val}")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def read_camera(intri_path: str, extri_path: str,
                cam_names: Optional[List[str]] = None) -> Dict:
    """Returns {cam: {K, invK, R, T, RT, P, dist}} plus 'basenames', as the
    JAX package's ``read_camera`` (``R`` by ``rodrigues`` of ``R_<cam>``)."""
    intri = read_storage(intri_path)
    extri = read_storage(extri_path)
    names = cam_names or [n for n in intri.get("names", []) if n != "none"]
    cams: Dict = {}
    for cam in names:
        K = intri[f"K_{cam}"]
        Rvec = extri[f"R_{cam}"]
        Tvec = extri[f"T_{cam}"]
        R = rodrigues(Rvec)
        RT = np.hstack([R, Tvec])
        cams[cam] = {
            "K": K, "invK": np.linalg.inv(K),
            "R": R, "T": Tvec, "RT": RT, "P": K @ RT,
            "dist": intri[f"dist_{cam}"],
        }
    cams["basenames"] = names
    return cams
