"""Gaia.ini generation: the simulation config contract.

The port's own copy of the JAX package's ``sim/ini.py`` (framework-free;
the port imports nothing of the JAX package): for the same config it
writes the same file, byte for byte. It emits the key=value ini files of
the reference's generator (prepare_gaia_ini.py:4-151) from a typed
config, read by the native C++ engine (native/gaia_engine.cpp,
``sim/gaia_native.py``) and kept readable by a real GAIA install. Keys
and defaults follow the reference: grid (126 layers, AR 4), Boussinesq
body/energy, FKViscosity rheology, COURANT stepping, MUMPS or iterative
momentum solver, MMSolverSkip/WarmUp, optional compressible energy (Di),
core cooling, and the 4-component radioactive-decay constants.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GaiaIniConfig:
    mode: str = "ML_STOKES"
    raq: float = 1.0
    fkt: float = 1e8
    fkp: float = 10.0
    advection_scheme: int = 2
    intervene_ts: int = 1
    warm_up_steps: int = 0
    solver: str = "mumps"           # "mumps" | "iterative"
    initialization: str = "hot"     # "hot" | "cold" | "linear" | "perfect"
    urf: float = 1.0
    Di: float = 0.0
    core_cool: bool = False
    radioactive_decay: bool = False
    layers: int = 126
    aspect_ratio: float = 4.0
    max_time: float = 10.0
    initial_dt: float = 1e-7
    max_dt: float = 1e-4
    profile_file: str = "ml_prof.txt"


def create_ini_file(path: str, cfg: GaiaIniConfig) -> None:
    """Write the Gaia.ini for ``cfg`` (format: prepare_gaia_ini.py:22-151)."""
    c = cfg
    lines = []
    add = lines.append

    # grid / restart (prepare_gaia_ini.py:22-28)
    add("GridFile = CREATE")
    add(f"BOX/Layers = {c.layers}")
    add(f"BOX/AspectRatio = {int(c.aspect_ratio)}")
    add("BOX/Dimensions = 2")
    add("Restart = no")

    # time stepping (prepare_gaia_ini.py:30-38)
    add(f"MaxTime = {c.max_time}")
    add(f"InitialDT = {c.initial_dt}")
    add(f"MaxDT = {c.max_dt}")
    add("TSType = COURANT")
    add("TSFactor = 1")
    add("SteadyState/Threshold = 1e-3")
    add("SteadyState/Value = 1")

    # output (prepare_gaia_ini.py:40-46)
    add(f"CaseID = {c.mode}")
    add("SnapshotIter = 10000000000000000000000")
    add("OutputIter = 1000000000000000000000")
    add("OutputTime = 0.")
    add("OutputType = TSPVv")

    # module wiring (prepare_gaia_ini.py:48-79)
    mc_init = "Box/Init, InitSphHarmonics"
    if c.initialization == "linear":
        mc_init += ", InitTempLinear"
    elif c.initialization == "perfect":
        mc_init += ", ReadASCII"
    mc_post_ts = "SteadyState"
    if c.core_cool and not c.radioactive_decay:
        mc_post_ts = "Core/Cooling"
        mc_init += ", Core/Init"
    elif c.radioactive_decay and not c.core_cool:
        mc_post_ts = "RadioactiveDecay"
        mc_init += ", RadioactiveDecay/Init"
    elif c.core_cool and c.radioactive_decay:
        # Deliberate fix of a reference bug: prepare_gaia_ini.py:75
        # assigns modules[5] = "Core/Cooling, RadioactiveDecay \n",
        # clobbering the "MCPostTS =" key itself, so the reference's ini
        # silently drops the hook in this combination. We keep the key.
        mc_post_ts = "Core/Cooling, RadioactiveDecay"
        mc_init += ", Core/Init, RadioactiveDecay/Init"
    energy = "Boussinesq/Compress" if c.Di > 0 else "Boussinesq"

    add(f"MCInit = {mc_init}")
    add("MCBody = Boussinesq")
    # the empty module slots are still emitted — a real GAIA install
    # expects every MC* hook key present (prepare_gaia_ini.py:50-58)
    add("MCPreTS = ")
    add("MCPostOuter = ")
    add("MCPrePressure = ")
    add(f"MCPostTS = {mc_post_ts}")
    add(f"MCEnergy = {energy}")
    add("MCRheology = FKViscosity")
    add("MCPreOutput = ")
    add("MCOutput = ")

    # radioactive decay / core constants (prepare_gaia_ini.py:81-92)
    add("RadioactiveDecay/nDecay = 4")
    add("RadioactiveDecay/Lambda0 = 14.200767386369366")
    add("RadioactiveDecay/Coeff0 = 0.130448695228009")
    add("RadioactiveDecay/Lambda1 = 90.1668042856123")
    add("RadioactiveDecay/Coeff1 = 0.2345333106414419")
    add("RadioactiveDecay/Lambda2 = 4.534102158362219")
    add("RadioactiveDecay/Coeff2 = 0.07981198571490902")
    add("RadioactiveDecay/Lambda3 = 50.78194417365685")
    add("RadioactiveDecay/Coeff3 = 0.55520600841564")
    add("Core/rhoCpVar = 0.7058823529411765")

    # initial condition (prepare_gaia_ini.py:94-101)
    init_temp = 0 if c.initialization == "cold" else 1
    add(f"InitialTemperature = {init_temp}")
    add("InitialModeL = -1")
    add("InitialModeM = -1")
    add("InitialAmp = 0.01")
    add(f"ReadASCII/Field/T = {c.profile_file}")

    # boundary conditions (prepare_gaia_ini.py:103-114)
    add("BCBottomVisc = 0")
    add("BCTopVisc = 0")
    add("BCBottomHFlow = no")
    add("BCBottomHValue = 1")
    add("BCTopHFlow = no")
    add("BCTopHValue = 0")
    add("ITL/TopLayerDepth = 0.05")
    add("ITL/TopLayerMax = 0.75")
    add("ITL/BottomLayerDepth = 0.95")
    add("ITL/BottomLayerMin = 0.75")

    # physics parameters (prepare_gaia_ini.py:116-126)
    add("Ra = 1e0")
    add(f"RaQ = {c.raq}")
    add(f"FKViscosity/ViscT = {c.fkt}")
    add(f"FKViscosity/ViscP = {c.fkp}")
    add(f"Di = {c.Di}")
    add("PrInverted = 0")
    add("Tref = 0")
    add("Dref = 0")
    add("T0 = 0")

    # numerics (prepare_gaia_ini.py:128-146)
    add("Debug = 2")
    add("IterLimitOuter = 1")
    add(f"Advection = {c.advection_scheme}")
    add("ViscosityStabilizer = 0")
    add(f"MMSolverSkip = {c.intervene_ts}")
    add(f"MMSolverSkipWarmUp = {c.warm_up_steps}")
    # lineout include + cadence (prepare_gaia_ini.py:134-135); GAIA
    # ignores a missing include file, as does our native engine.
    add("@ini/lineout.ini")
    add("LineOut/OutputEveryN = 10")
    if c.solver == "mumps":
        add("MMSolver = MUMPS")
        add("MUMPS/ICNTL_7 = 4")
        add("FixPressure = 7707")
    else:
        add(f"urf_mm = {c.urf}")

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def run_name(cfg: GaiaIniConfig, network: str = "", extra: str = "") -> str:
    """Run-directory naming mirroring advect_wi_gaia.py:149-214."""
    if cfg.mode == "GAIA":
        s = (f"raq_{cfg.raq}_fkt_{cfg.fkt}_fkv_{cfg.fkp}"
             f"_mmskip{cfg.intervene_ts}_sol{cfg.solver}_urf{cfg.urf}"
             f"_Di{cfg.Di}_start{cfg.initialization}")
    else:
        s = (f"{network}_raq_{cfg.raq}_fkt_{cfg.fkt}_fkv_{cfg.fkp}"
             f"{extra}_Di{cfg.Di}_start{cfg.initialization}"
             f"_sol{cfg.solver}")
    if cfg.core_cool:
        s += "_cool"
    if cfg.radioactive_decay:
        s += "_decay"
    return s
