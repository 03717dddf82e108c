"""Smoke run of the coupled dogbone OPLS HMM on one NVIDIA GPU.

    python chip_smoke.py               # every phase, one card
    python chip_smoke.py --four-cards  # the job batch sharded over 4 cards

Phases run one at a time, each in a child process; this parent process
never initialises a GPU backend, so one process uses each card.

  fe    Hooke-mode dogbone, 10 macro-steps, float64 and float32 on the GPU
        (one process each: x64 is on only for float64), against the
        committed golden stress field.
  md    Forces and virial of three MD boxes, float32 on the GPU against
        float64 references computed first by a host-CPU-only process from
        the same coordinates; SHAKE on the all-atom box; PME reciprocal
        energy against dense Ewald.
  run   The main path: ``python -m scema_tpu.cli run`` on the in-repo
        dogbone config for 3 macro-steps at full width (576 qps, one
        512-atom OPLS box per flagged qp, staged NPT material prep).
  four  (``--four-cards`` only) one dogbone macro-step with the MD job
        batch sharded over a 4-card "md" mesh, against the same step on
        one card.

Any failure, or a host without a GPU, exits non-zero and prints no result
line.  On success the last line is one JSON object naming the device.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "dogbone_cuboid.json")
GOLDEN = os.path.join(HERE, "tests", "golden", "dogbone_hooke_10step.npz")
DEADLINE_S = 1150.0  # the whole run, compilation included
RESULT_TAG = "PHASE_RESULT "

# Bounds, each with its reason (PERF.md "Findings", bring-up):
# float64 FE against the golden: the golden's own parity claim.
FE_F64_BOUND = 1e-6
# float32 FE: ten explicit steps accumulate float32 rounding (eps 6e-8)
# through assembly sums over 8 qps x 8 nodes per cell and the lumped-mass
# solve; relative to the largest stress.
FE_F32_BOUND = 1e-5
# MD forces, relative 2-norm of the error: float32 sums over ~130
# (united-atom) to ~900 (all-atom) neighbours with LJ and Coulomb terms
# that cancel to a net force far below each term.
FORCE_BOUND = 1e-4
# virial, error over the largest component: the same sums weighted by r,
# whose net is a small difference of large attractive/repulsive parts.
VIRIAL_BOUND = 1e-3
# SHAKE in float32: bond residual after the XLA SHAKE iterations (A).
SHAKE_BOUND = 1e-4
# PME reciprocal energy against dense Ewald, both at accuracy 1e-5: the
# 1e-4 claim of tests/test_pme.py (PME in float32 on the card).
PME_BOUND = 1e-4
# 4 cards vs 1: the same float32 programs at another batch width; XLA may
# sum in another order, and 110 chaotic MD steps grow last-bit
# differences.  Relative to the largest stress of the field.
SHARD_BOUND = 1e-3


def _card() -> str:
    """The card(s) as ``nvidia-smi`` reports name and power limit."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in r.stdout.splitlines()
                     if line.strip())


# ---------------------------------------------------------------- children


def _require_gpu(n_cards: int = 1):
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: jax backend is {jax.default_backend()!r}")
    if len(jax.devices()) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, jax sees {len(jax.devices())}")


def _device_report(n_cards: int = 1) -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": n_cards}


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def _check(name: str, err: float, bound: float, failures: list) -> None:
    ok = err < bound
    print(f"  {name}: error {err:.3e}  bound {bound:.0e}  "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        failures.append(name)


def _qp_order(xyz):
    import numpy as np

    key = np.round(xyz / 1e-9).astype(np.int64)
    return np.lexsort((key[:, 0], key[:, 1], key[:, 2]))


def fe_parity(dtype: str) -> dict:
    """Hooke-mode dogbone stress field after each of the golden's 10
    steps, relative error against the committed golden."""
    import jax
    import numpy as np
    from scema_tpu.config import load_config
    from scema_tpu.hmm.problem import build_hooke_hmm

    t0 = time.perf_counter()
    cfg = load_config(CONFIG, dtype=dtype)
    cfg = cfg.replace(bridging=cfg.bridging.__class__(
        stress_method=0, approx_md_with_hookes_law=True))
    hmm = build_hooke_hmm(cfg)
    state = jax.block_until_ready(hmm.init_state())
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = jax.jit(hmm.step).lower(state).compile()
    compile_s = time.perf_counter() - t0
    n_steps = 10
    sig = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, out = step(state)
        sig.append(state.qp.new_stress)
    jax.block_until_ready(state)
    step_s = (time.perf_counter() - t0) / n_steps
    sig = np.stack([np.asarray(s, np.float64) for s in sig])

    # qp coordinates in float64 on the host: they only key the matching
    g = hmm.geom
    nodes = np.asarray(hmm.problem.mesh.nodes, np.float64)
    xyz = np.einsum("qv,cvi->cqi", np.asarray(g.shapes, np.float64),
                    nodes[np.asarray(g.cells)]).reshape(-1, 3)
    gold = np.load(GOLDEN)
    ia, ib = _qp_order(xyz), _qp_order(gold["qp_xyz"])
    assert np.allclose(xyz[ia], gold["qp_xyz"][ib], atol=1e-6)
    ref = gold["sigma"][:, ib, :]
    err = float(np.abs(sig[:, ia, :] - ref).max() / np.abs(ref).max())
    return {"err": err, "setup_s": setup_s, "compile_s": compile_s,
            "step_s": step_s, "flagged": int(out.n_flagged),
            "jobs": int(out.n_jobs)}


def md_boxes():
    """(name, MaterialSpec) of the three parity boxes."""
    from scema_tpu.md.material import MaterialSpec

    return [
        # the dogbone's united-atom OPLS melt (64 x C8, 10 A cutoff)
        ("ua512", MaterialSpec(name="g0", force_field="opls")),
        # charged all-atom PE with SHAKE and PME (lj/cut/coul/long 12 9)
        ("aa1792", MaterialSpec(
            name="peaa", force_field="opls", allatom=True, n_chains=56,
            chain_length=10, pe_density=0.68, opls_lj_cutoff=12.0,
            opls_coul_cutoff=9.0, use_ewald=True, kspace="pme")),
        # Stillinger-Weber silicon, 3x3x3 diamond cells
        ("sw216", MaterialSpec(name="si", force_field="sw", n_cells=3)),
    ]


def _forces_virial(sys_):
    import jax
    from scema_tpu.md import engine as E

    def f(pos, h):
        nbr = sys_.build_neighbors(pos, h)
        F, _, W = E.forces_energy_virial(sys_, pos, h, nbr)
        return F, W

    return jax.jit(f)


def md_reference(spec, seed: int = 0) -> dict:
    """float64 reference of one box (run with x64 on the host CPU): the
    perturbed coordinates, forces, virial, a drifted step for SHAKE, and
    the dense-Ewald reciprocal energy of charged boxes."""
    import jax.numpy as jnp
    import numpy as np
    from scema_tpu.md import material as M

    sys64, st64 = M.build_system(spec, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    pos = np.asarray(st64.pos) + 0.05 * rng.normal(size=st64.pos.shape)
    h = np.asarray(st64.h)
    F, W = _forces_virial(sys64)(jnp.asarray(pos), jnp.asarray(h))
    ref = {"pos": pos, "h": h, "F": np.asarray(F), "W": np.asarray(W),
           "drift": pos + 0.02 * rng.normal(size=pos.shape)}
    if getattr(sys64.ff, "ewald", None) is not None:
        from scema_tpu.md.forcefields.coulomb import Ewald

        ew = Ewald.create(np.asarray(sys64.ff.charges), sys64.ff.coul_cutoff,
                          h, accuracy=1e-5, dtype=jnp.float64)
        ref["e_recip"] = np.asarray(
            ew.reciprocal_energy(jnp.asarray(pos), jnp.asarray(h)))
    return ref


def md_compare(spec, ref: dict) -> dict:
    """The same box in float32 on the default device, against ``ref``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scema_tpu.md import material as M

    t0 = time.perf_counter()
    sys32, _ = M.build_system(spec, dtype=jnp.float32)
    setup_s = time.perf_counter() - t0
    pos, h = (jnp.asarray(ref[k], jnp.float32) for k in ("pos", "h"))
    t0 = time.perf_counter()
    fn = _forces_virial(sys32).lower(pos, h).compile()
    compile_s = time.perf_counter() - t0
    F, W = (np.asarray(x, np.float64) for x in jax.block_until_ready(fn(pos, h)))
    out = {
        "atoms": int(pos.shape[0]),
        "k_max": int(sys32.nspec.k_max),
        "force_err": float(np.linalg.norm(F - ref["F"])
                           / np.linalg.norm(ref["F"])),
        "virial_err": float(np.abs(W - ref["W"]).max()
                            / np.abs(ref["W"]).max()),
        "setup_s": setup_s, "compile_s": compile_s,
    }
    cons = sys32.constraints
    if cons is not None:
        from scema_tpu.md import constraints as CN

        # one SHAKE correction of a drifted step
        pc = np.asarray(jax.jit(lambda p0, p1, hh: CN.shake_positions(
            cons, p0, p1, hh, 1.0 / sys32.masses))(
                pos, jnp.asarray(ref["drift"], jnp.float32), h), np.float64)
        i, j = np.asarray(cons.idx[:, 0]), np.asarray(cons.idx[:, 1])
        r = np.linalg.norm(pc[j] - pc[i], axis=1)
        mask = np.asarray(cons.mask)
        out["shake_residual"] = float(
            np.abs(r - np.asarray(cons.d0, np.float64))[mask].max())
        out["n_constraints"] = int(mask.sum())
    if "e_recip" in ref:
        from scema_tpu.md.forcefields.pme import PME

        pme = PME.create(np.asarray(sys32.ff.charges, np.float64),
                         sys32.ff.coul_cutoff, ref["h"], accuracy=1e-5,
                         dtype=jnp.float32)
        e = float(jax.jit(pme.reciprocal_energy)(pos, h))
        e_ref = float(ref["e_recip"])
        out["pme_err"] = abs(e - e_ref) / abs(e_ref)
    return out


def shard_parity(n_cards: int) -> dict:
    """One dogbone macro-step with the MD job batch sharded over
    ``n_cards`` devices, against the same step unsharded."""
    import dataclasses

    import jax
    import numpy as np
    from scema_tpu.config import load_config
    from scema_tpu.hmm.md_coupling import build_md_hmm
    from scema_tpu.parallel.mesh_utils import make_mesh

    cfg = load_config(CONFIG, dtype="float32", md_dtype="float32")
    t0 = time.perf_counter()
    # the short fixed-box prep: both sides share the prepared state, and
    # this phase is about the sharding, not the prep
    hmm_n = build_md_hmm(cfg, device_mesh=make_mesh(n_cards))
    hmm_1 = dataclasses.replace(hmm_n, backends=tuple(
        dataclasses.replace(be, device_mesh=None) for be in hmm_n.backends))
    setup_s = time.perf_counter() - t0
    res = {"setup_s": setup_s}
    sig = {}
    for tag, hmm in (("1", hmm_1), (str(n_cards), hmm_n)):
        carry = jax.block_until_ready(hmm.init_state())
        t0 = time.perf_counter()
        step = jax.jit(hmm.step).lower(carry).compile()
        res[f"compile_s_{tag}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        carry, out = jax.block_until_ready(step(carry))
        res[f"step_s_{tag}"] = time.perf_counter() - t0
        res[f"jobs_{tag}"] = int(out.n_jobs)
        sig[tag] = np.asarray(carry[0].qp.new_stress, np.float64)
    ref = sig["1"]
    res["err"] = float(np.abs(sig[str(n_cards)] - ref).max()
                       / np.abs(ref).max())
    res["finite"] = bool(np.isfinite(sig[str(n_cards)]).all())
    res["flagged"] = int(out.n_flagged)
    return res


def _finish(failures: list, n_cards: int = 1) -> int:
    print(f"  peak device memory (card 0) {_peak_bytes()} bytes", flush=True)
    print(RESULT_TAG + json.dumps({"ok": not failures,
                                   "device": _device_report(n_cards)}))
    return 1 if failures else 0


def child_fe(dtype: str) -> int:
    """FE parity in one precision (float64 runs with x64 on)."""
    _require_gpu()
    failures = []
    r = fe_parity(dtype)
    print(f"  FE Hooke dogbone {dtype}: set-up {r['setup_s']:.3f} s, "
          f"compile {r['compile_s']:.3f} s, {r['step_s']:.6f} s per "
          f"macro-step, flagged qps {r['flagged']}, jobs {r['jobs']}",
          flush=True)
    bound = FE_F64_BOUND if dtype == "float64" else FE_F32_BOUND
    _check(f"FE {dtype} stress vs golden", r["err"], bound, failures)
    return _finish(failures)


def child_md_reference(out_dir: str) -> int:
    """float64 references on the host CPU (x64 on, no GPU touched)."""
    import numpy as np

    for name, spec in md_boxes():
        np.savez(os.path.join(out_dir, f"{name}.npz"), **md_reference(spec))
        print(f"  MD {name}: float64 reference written", flush=True)
    return 0


def child_md(out_dir: str) -> int:
    """float32 forces, virial, SHAKE and PME on the GPU vs the references."""
    import numpy as np

    _require_gpu()
    failures = []
    for name, spec in md_boxes():
        ref = dict(np.load(os.path.join(out_dir, f"{name}.npz")))
        r = md_compare(spec, ref)
        print(f"  MD {name}: {r['atoms']} atoms, k_max {r['k_max']}, "
              f"set-up {r['setup_s']:.3f} s, compile {r['compile_s']:.3f} s",
              flush=True)
        _check(f"MD {name} forces (f32 GPU vs f64 CPU)", r["force_err"],
               FORCE_BOUND, failures)
        _check(f"MD {name} virial (f32 GPU vs f64 CPU)", r["virial_err"],
               VIRIAL_BOUND, failures)
        if "shake_residual" in r:
            _check(f"MD {name} SHAKE bond residual, {r['n_constraints']} "
                   "bonds (A)", r["shake_residual"], SHAKE_BOUND, failures)
        if "pme_err" in r:
            _check(f"MD {name} PME recip energy vs dense Ewald",
                   r["pme_err"], PME_BOUND, failures)
    return _finish(failures)


def child_four() -> int:
    _require_gpu(4)
    failures = []
    r = shard_parity(4)
    print(f"  dogbone macro-step, job batch over 4 cards vs 1: set-up "
          f"{r['setup_s']:.3f} s; 1 card compile {r['compile_s_1']:.3f} s, "
          f"{r['step_s_1']:.6f} s per macro-step; 4 cards compile "
          f"{r['compile_s_4']:.3f} s, {r['step_s_4']:.6f} s per macro-step; "
          f"flagged qps {r['flagged']}, jobs {r['jobs_4']}", flush=True)
    if not r["finite"] or r["jobs_1"] != r["jobs_4"]:
        failures.append("four-card stresses finite, same jobs")
    _check("4-card vs 1-card stress field", r["err"], SHARD_BOUND, failures)
    return _finish(failures, n_cards=4)


def _child(argv) -> int:
    from scema_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    name, rest = argv[0], argv[1:]
    if name == "fe":
        return child_fe(*rest)
    if name == "md_reference":
        return child_md_reference(*rest)
    if name == "md":
        return child_md(*rest)
    if name == "four":
        return child_four()
    raise SystemExit(f"unknown phase {name!r}")


# ---------------------------------------------------------------- parent


def _run_child(cmd, env, budget_s):
    """Run one phase, echo its output, return (rc, stdout)."""
    try:
        r = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=budget_s)
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        sys.stdout.write(out)
        print(f"phase timed out after {budget_s:.0f} s", file=sys.stderr)
        return 124, out
    sys.stdout.write(r.stdout)
    sys.stdout.flush()
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-8000:])
    return r.returncode, r.stdout


def _phase_result(stdout: str):
    for line in reversed(stdout.splitlines()):
        if line.startswith(RESULT_TAG):
            return json.loads(line[len(RESULT_TAG):])
    return None


def _check_main_path(stdout: str) -> list:
    """What ``cli run`` printed: a GPU device, three finite macro-steps in
    which every flagged qp ran its MD job, and the timing lines."""
    import math
    import re

    problems = []
    dev = re.search(r"^Device: (\S+) ", stdout, re.M)
    if not dev or dev.group(1) != "gpu":
        problems.append(f"device line: {dev.group(0) if dev else None}")
    steps = re.findall(
        r"^Timestep (\d+) .*residual (\S+) -> (\S+)  flagged qps (\d+)  "
        r"md jobs (\d+)  reaction (\S+)", stdout, re.M)
    if len(steps) != 3:
        problems.append(f"{len(steps)} macro-steps, expected 3")
    for ts, r0, r1, flagged, jobs, rf in steps:
        if not all(math.isfinite(float(x)) for x in (r0, r1, rf)):
            problems.append(f"step {ts}: non-finite output")
        if int(jobs) != int(flagged) or int(flagged) == 0:
            problems.append(f"step {ts}: {jobs} jobs for {flagged} flagged")
    if steps and int(steps[0][3]) != 144:
        problems.append(f"step 1 flagged {steps[0][3]}, expected 144")
    disp = re.search(r"^Max displacement: (\S+) m", stdout, re.M)
    if not disp or not (float(disp.group(1)) > 0
                        and math.isfinite(float(disp.group(1)))):
        problems.append("max displacement missing or not finite")
    for key in ("Set-up:", "Compile:", "Seconds per macro-step:",
                "Peak device memory:"):
        if key not in stdout:
            problems.append(f"missing line {key!r}")
    return problems


def main(argv) -> int:
    four = "--four-cards" in argv
    if not (os.path.isdir(os.path.join(HERE, "scema_tpu"))
            and os.path.exists(CONFIG) and os.path.exists(GOLDEN)):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    try:
        card = _card()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"no NVIDIA GPU found (nvidia-smi: {e})", file=sys.stderr)
        return 2
    env = {**os.environ, "PYTHONPATH": HERE + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    x64 = {"JAX_ENABLE_X64": "1"}
    me = [sys.executable, os.path.abspath(__file__), "--phase"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    if four:
        phases = [("four", me + ["four"], {})]
    else:
        phases = [
            ("fe float64", me + ["fe", "float64"], x64),
            ("fe float32", me + ["fe", "float32"], {}),
            ("md reference (host CPU, float64)", me + ["md_reference", tmp],
             {**x64, "JAX_PLATFORMS": "cpu"}),
            ("md", me + ["md", tmp], {}),
            ("run", [sys.executable, "-m", "scema_tpu.cli", "run", CONFIG,
                     "--steps", "3", "--max-retries", "0"], {}),
        ]
    try:
        return _run_phases(phases, env, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run_phases(phases, env, card) -> int:
    t_start = time.perf_counter()
    device = None
    for name, cmd, extra in phases:
        left = DEADLINE_S - (time.perf_counter() - t_start)
        print(f"== phase {name} on {card}", flush=True)
        t0 = time.perf_counter()
        rc, out = _run_child(cmd, {**env, **extra}, max(left, 1.0))
        print(f"== phase {name}: rc {rc}, {time.perf_counter() - t0:.1f} s "
              f"wall ({card})", flush=True)
        if rc != 0:
            return 1
        if name == "run":
            problems = _check_main_path(out)
            if problems:
                print("main path check failed: " + "; ".join(problems),
                      file=sys.stderr)
                return 1
            continue
        if name.startswith("md reference"):
            continue
        res = _phase_result(out)
        if not res or not res.get("ok"):
            print(f"phase {name} reported failure", file=sys.stderr)
            return 1
        device = res["device"]
    if device is None or device.get("platform") != "gpu":
        print(f"no GPU result: {device}", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--phase":
        sys.exit(_child(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
