"""Configuration schema for HMM runs.

Mirrors the reference JSON schema (reference: docs/configuration.md,
dealammps.cc:213-339 ``read_inputs``) so that a reference user's ``inputs.json``
can be loaded unchanged.  Parsed into frozen dataclasses; everything static
needed for jit-compilation (mesh sizes, step counts, method switches) lives
here.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


def _get(d: Mapping[str, Any], key: str, default=None, required=False):
    if key in d:
        return d[key]
    if required:
        raise KeyError(f"missing required config key: {key!r}")
    return default


@dataclass(frozen=True)
class ProblemTypeConfig:
    """reference: dealammps.cc:219-227; FE_problem_type.h."""

    cls: str = "dogbone"  # dogbone | dropweight | compact
    strain_rate: float = 0.002
    # dropweight extras (drop_weight.h:10-14)
    steps_to_accelerate: int = 0
    acceleration: float = 0.0
    diameter: float = 0.0
    # compact-tension extras (compact_tension.h:10-18)
    velocity: float = 0.0


@dataclass(frozen=True)
class ScaleBridgingConfig:
    """reference: dealammps.cc:230-238.

    stress_method: 0 = molecular model, 1 = analytic tangent Hooke,
    2 = surrogate model (FE_problem.h:1631-1752).
    approx_md_with_hookes_law replaces the MD kernel with sigma = C:eps
    (stmd_problem.h:479-483) while keeping the full bridging path intact.
    """

    stress_method: int = 0
    approx_md_with_hookes_law: bool = False
    use_pjm_scheduler: bool = False


@dataclass(frozen=True)
class TimeConfig:
    """reference: dealammps.cc:241-245."""

    timestep_length: float = 5.0e-7
    start_timestep: int = 1
    end_timestep: int = 500


@dataclass(frozen=True)
class MeshConfig:
    """reference: dealammps.cc:248-266; FE_problem_type.h:39-58."""

    fe_degree: int = 1
    quadrature_formula: int = 2
    style: str = "cuboid"  # cuboid | file3D | file2D
    x_length: float = 0.03
    y_length: float = 0.03
    z_length: float = 0.08
    x_cells: int = 3
    y_cells: int = 3
    z_cells: int = 8
    mesh_file: str = ""
    extrude_length: float = 0.0
    extrude_points: int = 0
    # compact-tension CalculiX Crack1 geometry params (compact_tension.h:15-17)
    calculi_B: float = 0.0
    calculi_a: float = 0.0
    calculi_t: float = 0.0


@dataclass(frozen=True)
class PrecisionConfig:
    """reference: 'model precision' subtree (FE_problem.h:1120,
    dealammps.cc "min quadrature strain norm", clustering keys)."""

    min_quadrature_strain_norm: float = 1.0e-10
    spline_points: int = 10
    clustering_min_steps: int = 500
    clustering_diff_threshold: float = 1.0e-6


@dataclass(frozen=True)
class MaterialConfig:
    """reference: dealammps.cc:269-278 ('molecular dynamics material')."""

    number_of_replicas: int = 1
    materials: Sequence[str] = ("g0",)
    distribution_style: str = "uniform"
    proportions: Sequence[float] = (1.0,)
    common_ground_vector: Sequence[float] = (1.0, 0.0, 0.0)


@dataclass(frozen=True)
class MDParamsConfig:
    """reference: dealammps.cc:280-285 ('molecular dynamics parameters').

    Units follow LAMMPS 'real' units (lammps_scripts_*/in.set.lammps):
    femtoseconds, Kelvin, angstroms.
    """

    temperature: float = 300.0
    timestep_length: float = 2.0  # fs
    strain_rate: float = 1.0e-4  # 1/fs
    nsteps_sample: int = 100
    scripts_directory: str = "./lammps_scripts_opls"
    force_field: str = "opls"  # opls | reax | sw  (sw: framework-native Si)


@dataclass(frozen=True)
class ResourcesConfig:
    """reference: 'computational resources' (stmd_sync.h:189-278).

    In this rebuild the MPI core partitioner disappears; these knobs
    parameterize the padded batched-MD dispatcher instead
    (parallel/dispatch.py).
    """

    machine_cores_per_node: int = 24
    fe_cores_max: int = 10
    md_cores_min: int = 1
    max_md_jobs: int = 0  # 0 = auto (all flagged qps x replicas)


@dataclass(frozen=True)
class OutputConfig:
    """reference: dealammps.cc:286-291 ('output data')."""

    checkpoint_frequency: int = 100
    visualisation_frequency: int = 1
    analytics_frequency: int = 1
    loaded_boundary_force_frequency: int = 1
    homogenization_frequency: int = 1000


@dataclass(frozen=True)
class DirectoryConfig:
    """reference: dealammps.cc:294-312 ('directory structure')."""

    macroscale_input: str = "./macroscale_input"
    nanoscale_input: str = "./nanoscale_input"
    macroscale_output: str = "./macroscale_output"
    nanoscale_output: str = "./nanoscale_output"
    macroscale_restart: str = "./macroscale_restart"
    nanoscale_restart: str = "./nanoscale_restart"
    macroscale_log: str = "./macroscale_log"
    nanoscale_log: str = "./nanoscale_log"


@dataclass(frozen=True)
class HMMConfig:
    problem: ProblemTypeConfig = field(default_factory=ProblemTypeConfig)
    bridging: ScaleBridgingConfig = field(default_factory=ScaleBridgingConfig)
    time: TimeConfig = field(default_factory=TimeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    material: MaterialConfig = field(default_factory=MaterialConfig)
    md: MDParamsConfig = field(default_factory=MDParamsConfig)
    resources: ResourcesConfig = field(default_factory=ResourcesConfig)
    output: OutputConfig = field(default_factory=OutputConfig)
    dirs: DirectoryConfig = field(default_factory=DirectoryConfig)
    # extras with no reference equivalent:
    dtype: str = "float64"  # FE state dtype; float64 for CPU parity tests
    md_dtype: str = "float32"  # MD engine dtype
    seed: int = 0  # replaces mt19937(time(0)) at FE.h:192 with a fixed seed

    def replace(self, **kw) -> "HMMConfig":
        return dataclasses.replace(self, **kw)


def _problem(d):
    p = d.get("problem type", {})
    return ProblemTypeConfig(
        cls=_get(p, "class", "dogbone"),
        strain_rate=float(_get(p, "strain rate", 0.002)),
        steps_to_accelerate=int(_get(p, "steps to accelerate", 0)),
        acceleration=float(_get(p, "acceleration", 0.0)),
        diameter=float(_get(p, "diameter", 0.0)),
        velocity=float(_get(p, "velocity", 0.0)),
    )


def _bridging(d):
    s = d.get("scale-bridging", {})
    return ScaleBridgingConfig(
        stress_method=int(_get(s, "stress computation method", 0)),
        approx_md_with_hookes_law=bool(int(_get(s, "approximate md with hookes law", 0))),
        use_pjm_scheduler=bool(int(_get(s, "use pjm scheduler", 0))),
    )


def _time(d):
    t = d.get("continuum time", {})
    return TimeConfig(
        timestep_length=float(_get(t, "timestep length", 5.0e-7)),
        start_timestep=int(_get(t, "start timestep", 1)),
        end_timestep=int(_get(t, "end timestep", 500)),
    )


def _mesh(d):
    m = d.get("continuum mesh", {})
    i = m.get("input", {})
    fe_degree = int(_get(m, "fe degree", 1))
    if fe_degree != 1:
        # the reference's FE_Q(degree) is configurable (dealammps.cc:276);
        # this rebuild implements trilinear Q1 hexes only — refuse loudly
        # rather than silently solving a different discretization
        raise NotImplementedError(
            f"'fe degree' = {fe_degree}: only degree-1 (Q1 trilinear hex) "
            "elements are implemented; refine the mesh instead"
        )
    return MeshConfig(
        fe_degree=fe_degree,
        quadrature_formula=int(_get(m, "quadrature formula", 2)),
        style=_get(i, "style", "cuboid"),
        x_length=float(_get(i, "x length", 0.03)),
        y_length=float(_get(i, "y length", 0.03)),
        z_length=float(_get(i, "z length", 0.08)),
        x_cells=int(_get(i, "x cells", 3)),
        y_cells=int(_get(i, "y cells", 3)),
        z_cells=int(_get(i, "z cells", 8)),
        mesh_file=_get(i, "filename", _get(i, "file", "")),
        extrude_length=float(_get(i, "extrude length", 0.0)),
        extrude_points=int(_get(i, "extrude points", 0)),
        calculi_B=float(_get(i, "calculi_B", 0.0)),
        calculi_a=float(_get(i, "calculi_a", 0.0)),
        calculi_t=float(_get(i, "calculi_t", 0.0)),
    )


def _precision(d):
    p = d.get("model precision", {})
    md = p.get("md", {})
    cl = p.get("clustering", {})
    return PrecisionConfig(
        min_quadrature_strain_norm=float(_get(md, "min quadrature strain norm", 1.0e-10)),
        spline_points=int(_get(cl, "spline points", _get(cl, "points", 10))),
        clustering_min_steps=int(_get(cl, "min steps", 500)),
        clustering_diff_threshold=float(_get(cl, "diff threshold", 1.0e-6)),
    )


def _material(d):
    m = d.get("molecular dynamics material", {})
    dist = m.get("distribution", {})
    return MaterialConfig(
        number_of_replicas=int(_get(m, "number of replicas", 1)),
        materials=tuple(_get(m, "list of materials", ["g0"])),
        distribution_style=_get(dist, "style", "uniform"),
        proportions=tuple(float(x) for x in _get(dist, "proportions", [1.0])),
        common_ground_vector=tuple(
            float(x) for x in _get(m, "rotation common ground vector", [1.0, 0.0, 0.0])
        ),
    )


def _mdparams(d):
    m = d.get("molecular dynamics parameters", {})
    scripts = _get(m, "scripts directory", "./lammps_scripts_opls")
    ff = _get(m, "force field", "opls")
    if "sisw" in scripts:
        # the shipped streched_polyhedron example declares 'opls' but
        # points at the Stillinger-Weber script set — resolve the quirk
        # ONCE here so every consumer sees the effective force field
        ff = "sw"
    if "reax" in scripts:
        # a reax scripts directory selects pair_style reax/c + fix
        # qeq/reax regardless of the declared force-field string
        # (lammps_scripts_reax/in.strain.lammps:10-12); resolve the
        # effective field once, like the sisw quirk above
        ff = "reax"
    return MDParamsConfig(
        temperature=float(_get(m, "temperature", 300.0)),
        timestep_length=float(_get(m, "timestep length", 2.0)),
        strain_rate=float(_get(m, "strain rate", 1.0e-4)),
        nsteps_sample=int(_get(m, "number of sampling steps", 100)),
        scripts_directory=scripts,
        force_field=ff,
    )


def _resources(d):
    r = d.get("computational resources", {})
    return ResourcesConfig(
        machine_cores_per_node=int(_get(r, "machine cores per node", 24)),
        fe_cores_max=int(_get(r, "maximum number of cores for FEM simulation", 10)),
        md_cores_min=int(_get(r, "minimum number of cores for MD simulation", 1)),
        max_md_jobs=int(_get(r, "maximum md jobs", 0)),
    )


def _output(d):
    o = d.get("output data", {})
    return OutputConfig(
        checkpoint_frequency=int(_get(o, "checkpoint frequency", 100)),
        visualisation_frequency=int(_get(o, "visualisation output frequency", 1)),
        analytics_frequency=int(_get(o, "analytics output frequency", 1)),
        loaded_boundary_force_frequency=int(
            _get(o, "loaded boundary force output frequency", 1)
        ),
        homogenization_frequency=int(_get(o, "homogenization output frequency", 1000)),
    )


def _dirs(d):
    s = d.get("directory structure", {})
    return DirectoryConfig(
        macroscale_input=_get(s, "macroscale input", "./macroscale_input"),
        nanoscale_input=_get(s, "nanoscale input", "./nanoscale_input"),
        macroscale_output=_get(s, "macroscale output", "./macroscale_output"),
        nanoscale_output=_get(s, "nanoscale output", "./nanoscale_output"),
        macroscale_restart=_get(s, "macroscale restart", "./macroscale_restart"),
        nanoscale_restart=_get(s, "nanoscale restart", "./nanoscale_restart"),
        macroscale_log=_get(s, "macroscale log", "./macroscale_log"),
        nanoscale_log=_get(s, "nanoscale log", "./nanoscale_log"),
    )


def config_from_dict(d: Mapping[str, Any], **overrides) -> HMMConfig:
    """Build an HMMConfig from a reference-schema JSON dict."""
    cfg = HMMConfig(
        problem=_problem(d),
        bridging=_bridging(d),
        time=_time(d),
        mesh=_mesh(d),
        precision=_precision(d),
        material=_material(d),
        md=_mdparams(d),
        resources=_resources(d),
        output=_output(d),
        dirs=_dirs(d),
    )
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def load_config(path: str, **overrides) -> HMMConfig:
    """Load a reference-format ``inputs.json`` (dealammps.cc:213-339).

    A relative mesh ``filename`` is resolved against the config's directory.
    """
    import os

    with open(path) as f:
        d = json.load(f)
    cfg = config_from_dict(d, **overrides)
    mf = cfg.mesh.mesh_file
    if mf and not os.path.isabs(mf) and not os.path.exists(mf):
        cand = os.path.join(os.path.dirname(os.path.abspath(path)), mf)
        if os.path.exists(cand):
            cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, mesh_file=cand))
    # the nanoscale-input dir (replica metadata + init.* files) resolves the
    # same way — configs ship with paths relative to their own location
    nd = cfg.dirs.nanoscale_input
    if nd and not os.path.isabs(nd) and not os.path.isdir(nd):
        cand = os.path.join(os.path.dirname(os.path.abspath(path)), nd)
        if os.path.isdir(cand):
            cfg = cfg.replace(
                dirs=dataclasses.replace(cfg.dirs, nanoscale_input=cand))
    # the MD scripts directory (where reax configs keep ffield.reax*)
    # resolves against the config's location too; the reference moved
    # its script sets under a lammps_scripts/ umbrella, so try that
    # layout as a fallback (lammps_scripts/lammps_scripts_reax/...)
    sd = cfg.md.scripts_directory
    if sd and not os.path.isabs(sd) and not os.path.isdir(sd):
        base = os.path.dirname(os.path.abspath(path))
        for cand in (
            os.path.join(base, sd),
            os.path.join(base, "lammps_scripts", os.path.basename(sd)),
            os.path.join(base, "..", "lammps_scripts",
                         os.path.basename(sd)),
        ):
            if os.path.isdir(cand):
                cfg = cfg.replace(md=dataclasses.replace(
                    cfg.md, scripts_directory=os.path.normpath(cand)))
                break
    return cfg


def reax_ffield_path(scripts_directory: str) -> str:
    """Locate the ReaxFF parameter file in a reax scripts directory
    (the reference ships ``ffield.reax.2`` next to in.set.lammps and
    passes it via ``pair_coeff * * ${locs}/ffield.reax.2 H C N O``)."""
    import glob
    import os

    cands = sorted(glob.glob(
        os.path.join(scripts_directory, "ffield.reax*")))
    if not cands:
        raise FileNotFoundError(
            f"no ffield.reax* parameter file in {scripts_directory!r} "
            "(required for force field 'reax')")
    return cands[0]


def md_spec_kwargs(cfg: "HMMConfig") -> dict:
    """MaterialSpec keyword arguments implied by a loaded config: the
    effective force field, plus the ffield path for reax runs."""
    ff = cfg.md.force_field
    kw = dict(force_field=ff)
    if ff == "reax":
        kw["reax_ffield"] = reax_ffield_path(cfg.md.scripts_directory)
    return kw
