"""ctypes binding to the native C++ simulation engine.

Replicates the GAIA Python binding contract the reference drives
(advect_wi_gaia.py:19-21, 538-555):

    sim = Direct(); sim.init1(); sim.iniLoad("ini/default.ini");
    sim.iniLoad(gaia_ini); sim.init2()
    state = sim.getState()          # {T, v, P, V, pos, raw.time}
    dt = sim.doTimestep()

``state`` values are zero-copy numpy views over the C++ buffers, so
writing ``state["v"][:, :] = ...`` mutates engine state exactly like the
reference's per-step exchange (advect_wi_gaia.py:603-637).

The port's own binding of the repo's ``native/gaia_engine.cpp`` (the
same C interface as the JAX package's ``sim/gaia_native.py``; the port
imports nothing of it). The C++ engine is GAIA's stand-in and runs on the
host, as it does beside JAX. The shared library is compiled on first use
(g++ -O3) into ``build/native/`` beside the package (a directory git
ignores), its own file, so that both bindings can be loaded in one
process, each with its library. A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = str(_ROOT / "native" / "gaia_engine.cpp")
BUILD_DIR = _ROOT / "build" / "native"

_lib: Optional[ctypes.CDLL] = None


def _build_lib() -> str:
    """Compile ``native/gaia_engine.cpp`` into ``build/native/`` unless an
    up-to-date build is there; a failed ``g++`` raises a RuntimeError
    with the compiler's message."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = str(BUILD_DIR / "libgaia_engine.so")
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(_SRC)):
        return so_path
    # compile to a private name and os.replace (atomic): concurrent
    # processes (pytest-xdist workers) must never dlopen a half-written
    # .so when they race on the shared cache path
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
           "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {_SRC} failed:\n{e.stderr}") from e
    os.replace(tmp_path, so_path)
    return so_path


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    so_path = _build_lib()
    lib = ctypes.CDLL(so_path)
    lib.gaia_create.restype = ctypes.c_void_p
    for f in ["gaia_init1", "gaia_init2", "gaia_destroy"]:
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.gaia_ini_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.gaia_ini_load.restype = ctypes.c_int
    for f in ["gaia_h", "gaia_w", "gaia_size"]:
        getattr(lib, f).argtypes = [ctypes.c_void_p]
        getattr(lib, f).restype = ctypes.c_int
    for f in ["gaia_state_T", "gaia_state_V", "gaia_state_P",
              "gaia_state_v", "gaia_state_pos"]:
        getattr(lib, f).argtypes = [ctypes.c_void_p]
        getattr(lib, f).restype = ctypes.POINTER(ctypes.c_double)
    lib.gaia_time.argtypes = [ctypes.c_void_p]
    lib.gaia_time.restype = ctypes.c_double
    lib.gaia_set_time.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.gaia_do_timestep.argtypes = [ctypes.c_void_p]
    lib.gaia_do_timestep.restype = ctypes.c_double
    lib.gaia_do_timestep_dt.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.gaia_do_timestep_dt.restype = ctypes.c_double
    lib.gaia_set_solve_momentum.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gaia_solve_momentum.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gaia_update_viscosity.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class _Raw:
    """Mirror of the reference's ``state["raw"]`` handle whose ``time``
    attribute the driver assigns (advect_wi_gaia.py:637)."""

    def __init__(self, lib, handle):
        object.__setattr__(self, "_lib", lib)
        object.__setattr__(self, "_h", handle)

    @property
    def time(self):
        return self._lib.gaia_time(self._h)

    def __setattr__(self, name, value):
        if name == "time":
            self._lib.gaia_set_time(self._h, float(value))
        else:
            object.__setattr__(self, name, value)


class Direct:
    """The GAIA binding class, natively implemented (see module doc)."""

    def __init__(self):
        self._lib = load_library()
        self._h = self._lib.gaia_create()
        self._state = None

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.gaia_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def init1(self):
        self._lib.gaia_init1(self._h)

    def iniLoad(self, path: str):
        if os.path.exists(path):
            self._lib.gaia_ini_load(self._h, path.encode())

    def init2(self):
        self._lib.gaia_init2(self._h)
        n = self._lib.gaia_size(self._h)

        def view(fn, shape):
            ptr = fn(self._h)
            size = int(np.prod(shape))
            return np.ctypeslib.as_array(ptr, shape=(size,)).reshape(shape)

        self._state = {
            "T": view(self._lib.gaia_state_T, (n,)),
            "V": view(self._lib.gaia_state_V, (n,)),
            "P": view(self._lib.gaia_state_P, (n,)),
            "v": view(self._lib.gaia_state_v, (n, 3)),
            "pos": view(self._lib.gaia_state_pos, (n, 2)),
            "raw": _Raw(self._lib, self._h),
        }

    @property
    def shape(self):
        return (self._lib.gaia_h(self._h), self._lib.gaia_w(self._h))

    def getState(self):
        return self._state

    def doTimestep(self) -> float:
        return self._lib.gaia_do_timestep(self._h)

    def doTimestepDt(self, dt: float) -> float:
        """Step with an externally prescribed dt (testing hook; real GAIA
        has no such entry — used for cross-implementation equivalence
        tests against the JAX energy step)."""
        return self._lib.gaia_do_timestep_dt(self._h, float(dt))

    def setSolveMomentum(self, on: bool):
        """Enable the native iterative momentum solve inside doTimestep
        (the GAIA urf_mm mode, prepare_gaia_ini.py:146). Off by default so
        ML modes keep caller-provided velocities; MMSolverSkip/WarmUp from
        the ini govern which steps solve."""
        self._lib.gaia_set_solve_momentum(self._h, 1 if on else 0)

    def solveMomentum(self, n_iter: int = 0):
        """Run one momentum solve now (n_iter=0: the ini's MMSolverIter).
        Testing hook for native-vs-JAX solver equivalence."""
        self._lib.gaia_solve_momentum(self._h, int(n_iter))

    def updateViscosity(self):
        """Recompute FK viscosity from the current T buffer (after the
        caller writes state['T'] directly)."""
        self._lib.gaia_update_viscosity(self._h)
