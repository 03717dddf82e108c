"""Command-line entry points (the reference's executables, SURVEY.md 2.1).

``python -m scema_tpu.cli run <inputs.json>``      — dealammps equivalent
``python -m scema_tpu.cli init-material <json>``   — init_material equivalent
``python -m scema_tpu.cli strain-md <json>``       — strain_md equivalent
``python -m scema_tpu.cli analyse-md <json>``      — analyse_md equivalent

reference: dealammps.cc:542-601 (main), init_material.cc, strain_md.cc,
analyse_md.cc — each takes a single JSON config path.
"""
from __future__ import annotations

import argparse
import sys
import time


def cmd_run(args) -> int:
    import jax

    t_setup = time.perf_counter()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from .config import load_config
    from .hmm.problem import build_hooke_hmm

    overrides = {}
    if args.cpu:
        overrides["dtype"] = "float64"
    else:
        overrides["dtype"] = "float32"
    import os

    if not os.path.exists(args.config):
        print(f"error: config file not found: {args.config}", file=sys.stderr)
        return 2
    cfg = load_config(args.config, **overrides)

    if args.hooke:
        cfg = cfg.replace(
            bridging=cfg.bridging.__class__(
                stress_method=cfg.bridging.stress_method,
                approx_md_with_hookes_law=True,
                use_pjm_scheduler=False,
            )
        )
    if args.max_jobs:
        import dataclasses as _dc

        cfg = cfg.replace(
            resources=_dc.replace(cfg.resources, max_md_jobs=args.max_jobs)
        )

    n_steps = args.steps or (cfg.time.end_timestep - cfg.time.start_timestep + 1)

    surrogate_fn = None
    if args.surrogate:
        # reference pretrained Keras surrogate + sklearn scaler
        # (surrogate_model/surrogate.py); point at the directory holding
        # model_small_uniaxial.bin + scaler.pkl, or at the .bin itself
        import os as _os

        from .bridging.surrogate import load_keras_surrogate

        sp = args.surrogate
        if _os.path.isdir(sp):
            model_p = _os.path.join(sp, "model_small_uniaxial.bin")
            scaler_p = _os.path.join(sp, "scaler.pkl")
        else:
            model_p = sp
            scaler_p = _os.path.join(_os.path.dirname(sp), "scaler.pkl")
        scaler_p = scaler_p if _os.path.exists(scaler_p) else None
        surrogate_fn = load_keras_surrogate(model_p, scaler_p).as_update_fn()
        print(f"Loaded surrogate {model_p} (scaler: {scaler_p})")
        if cfg.bridging.stress_method != 2:
            # a loaded surrogate only drives the constitutive update under
            # stress method 2 — silently running full MD instead would
            # ignore the user's flag
            print("--surrogate given: overriding 'stress computation "
                  f"method' {cfg.bridging.stress_method} -> 2")
            cfg = cfg.replace(
                bridging=cfg.bridging.__class__(
                    stress_method=2,
                    approx_md_with_hookes_law=cfg.bridging.approx_md_with_hookes_law,
                    use_pjm_scheduler=cfg.bridging.use_pjm_scheduler,
                )
            )

    if cfg.bridging.approx_md_with_hookes_law or cfg.bridging.stress_method != 0:
        hmm = build_hooke_hmm(cfg, surrogate_fn=surrogate_fn)
    else:
        from .hmm.md_coupling import build_md_hmm

        # production material prep = the reference's in.init.lammps staged
        # heatup/cooldown NPT cycle; --quick-prep falls back to the short
        # fixed-box equilibration (debug/smoke runs)
        hmm = build_md_hmm(cfg, staged=not args.quick_prep)

    dev = jax.devices()[0]
    print(f"Device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    print(f"Problem: {cfg.problem.cls}  mesh {cfg.mesh.x_cells}x{cfg.mesh.y_cells}x"
          f"{cfg.mesh.z_cells}  qps {hmm.geom.n_qp_total}  dt {cfg.time.timestep_length}")
    state = hmm.init_state()

    def fe_of(s):
        # the MD-coupled carry is (FEState, MicroStates); FEState itself is
        # a NamedTuple, so dispatch on the field, not on tuple-ness
        return s if hasattr(s, "timestep") else s[0]

    from .hmm.checkpoint import save_checkpoint, load_checkpoint

    if args.restart:
        state = load_checkpoint(args.restart, state)
        print(f"Restarted from {args.restart} at timestep {int(fe_of(state).timestep)}")
    if args.restart_reference:
        # reference-produced lcts.* restart (FE_problem.h:540-712)
        from .fem.reference_restart import load_reference_restart

        mesh = hmm.base.problem.mesh if hasattr(hmm, "base") else hmm.problem.mesh
        if hasattr(state, "timestep"):
            state = load_reference_restart(
                args.restart_reference, state, hmm.geom, mesh)
        else:
            state = (load_reference_restart(
                args.restart_reference, state[0], hmm.geom, mesh),) + tuple(
                state[1:])
        # the reference resumes the step counter from the config's 'start
        # timestep'; infer it from the restored physical time so the
        # timestep-1 load increment is not re-applied on resume
        import jax.numpy as jnp

        ts0 = int(round(float(fe_of(state).time) / cfg.time.timestep_length))
        if hasattr(state, "timestep"):
            state = state._replace(timestep=jnp.asarray(ts0, jnp.int32))
        else:
            state = (state[0]._replace(timestep=jnp.asarray(ts0, jnp.int32)),
                     ) + tuple(state[1:])
        print(f"Restored reference restart from {args.restart_reference} "
              f"at time {float(fe_of(state).time):.6g} (timestep {ts0})")

    writer = None
    if args.outdir:
        from .fem.output import OutputWriter

        mesh = hmm.base.problem.mesh if hasattr(hmm, "base") else hmm.problem.mesh
        writer = OutputWriter(
            args.outdir, mesh.nodes, mesh.cells,
            resume=bool(args.restart or args.restart_reference),
            resume_timestep=int(fe_of(state).timestep)
            if (args.restart or args.restart_reference) else None,
        )
        # mesh wireframe EPS at init (FEProblem::visualise_mesh)
        writer.write_mesh_eps()

    jax.block_until_ready(state)
    print(f"Set-up: {time.perf_counter() - t_setup:.3f}s "
          "(config, material prep, initial state)")
    t0 = time.perf_counter()
    step = jax.jit(hmm.step).lower(state).compile()
    print(f"Compile: {time.perf_counter() - t0:.3f}s")

    if args.profile:
        jax.profiler.start_trace(args.profile)

    # fault recovery: device/runtime failures roll back to the last good
    # in-memory snapshot and retry.  The reference's only recovery story is
    # checkpoint/restart from disk after exit(1) (stmd_sync.h:585-606
    # documents an abandoned communicator-isolation attempt); here a
    # snapshot of the full two-scale carry costs one device-memory copy,
    # so the run self-heals through transient accelerator faults.
    last_good = state
    last_good_k = 0
    retries_left = args.max_retries

    t_total = time.perf_counter()
    step_walls = []
    k = 0
    while k < n_steps:
        t0 = time.perf_counter()
        try:
            state, out = step(state)
            jax.block_until_ready(state)
        except Exception as e:  # noqa: BLE001 — filtered just below
            # only runtime/device faults are transient; deterministic
            # errors (config/shape/dtype bugs) raise immediately instead
            # of burning max_retries full macro-steps on a guaranteed loss
            name = type(e).__name__
            transient = isinstance(e, (OSError, RuntimeError)) or (
                "RuntimeError" in name or "XlaRuntime" in name
                or "Internal" in name or "Unavailable" in name
            )
            if not transient or retries_left <= 0:
                raise
            retries_left -= 1
            print(f"step failed ({type(e).__name__}: {e}); rolling back to "
                  f"step {last_good_k} ({retries_left} retries left)",
                  file=sys.stderr)
            state = last_good
            k = last_good_k
            continue
        last_good, last_good_k = state, k + 1
        k += 1
        wall = time.perf_counter() - t0
        step_walls.append(wall)
        fe = fe_of(state)
        ts = int(fe.timestep)
        print(
            f"Timestep {ts} at time {float(fe.time):.6g}  "
            f"residual {float(out.residual0):.6g} -> {float(out.residual1):.6g}  "
            f"flagged qps {int(out.n_flagged)}  md jobs {int(out.n_jobs)}  "
            f"reaction {float(out.reaction_force):.6g}  ({wall:.3f}s)"
        )
        if out.cluster_saturated is not None and bool(out.cluster_saturated):
            # never a silent cap: truncated dedup = extra MD, not wrong
            # stresses (clustering/reduction.reduce_graph max_picks)
            print("note: similarity-dedup pick cap reached this step; "
                  "unreduced qps ran their own MD", file=sys.stderr)
        if writer is not None:
            o = cfg.output

            def due(freq):  # 0 = disabled (and never a ZeroDivisionError)
                return freq > 0 and ts % freq == 0

            if due(o.visualisation_frequency):
                writer.write_visualisation(fe, ts, float(fe.time))
                # the reference writes the DG-projected history VTU on the
                # same cadence (dealammps.cc output block -> FE_problem.h
                # output_visualisation_history :2050)
                writer.write_visualisation_history(fe, ts, float(fe.time))
            if due(o.loaded_boundary_force_frequency):
                writer.write_lbc_force(ts, float(fe.time), float(out.reaction_force))
            if due(o.analytics_frequency):
                writer.write_lhistory(fe, ts)
            if out.md_stress_repl is not None and due(o.homogenization_frequency):
                import numpy as _np

                ran = _np.nonzero(_np.asarray(out.md_ran))[0]
                writer.write_mddata(
                    ts, ran, _np.asarray(fe.qp.material), out.md_strain_cg,
                    out.md_stress_repl, cfg.md.temperature,
                    cfg.md.strain_rate, cfg.md.force_field,
                )
            if due(o.checkpoint_frequency):
                save_checkpoint(f"{args.outdir}/checkpoint-{ts:06d}.npz", state)
                # reference-format lcts.* alongside (FE_problem.h:2278-2335)
                from .fem.reference_restart import save_reference_checkpoint

                save_reference_checkpoint(f"{args.outdir}/restart", fe, mesh)
    if args.profile:
        jax.profiler.stop_trace()
        print(f"Profiler trace written to {args.profile}")
    import numpy as np

    if args.dump_similarity:
        # final-state similarity network for clustering.render_network —
        # the rebuild's analog of the reference's __results/ID_* edge
        # shards (strain2spline.h write_similar_histories)
        from .clustering.similarity import pairwise_l2
        from .clustering.spline import splinify_histories

        fe = fe_of(state)
        splines = splinify_histories(
            fe.hist.buffer, fe.hist.count, cfg.precision.spline_points)
        np.savez(args.dump_similarity,
                 dist=np.asarray(pairwise_l2(splines)),
                 threshold=np.float64(
                     cfg.precision.clustering_diff_threshold))
        print(f"Similarity network written to {args.dump_similarity}")

    u = np.asarray(fe_of(state).u).reshape(-1, 3)
    print(f"Max displacement: {np.abs(u).max():.6g} m")
    print(f"Total wall time: {time.perf_counter() - t_total:.2f}s for {n_steps} steps")
    if step_walls:
        print(f"Seconds per macro-step: {sum(step_walls) / len(step_walls):.6f} "
              f"(mean of {len(step_walls)})")
    stats = dev.memory_stats()
    if stats and "peak_bytes_in_use" in stats:
        print(f"Peak device memory: {stats['peak_bytes_in_use']} bytes")
    return 0


def cmd_init_material(args) -> int:
    """On-device material preparation (init_material.cc equivalent).

    For each (material x replica): build the box, minimize + thermalize,
    measure equilibrium lengths / residual stress / 6x6 stiffness /
    density, and write the reference-format init.<mat>_<n>.* files plus
    per-material common-ground averages (stmd_sync.h:455-489).
    """
    import jax
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from .config import load_config
    from .md import material as M
    from .md.homogenization import MDParams
    from .bridging import bridge
    from .utils import io_tensors as io
    from .utils import tensors as T
    import jax.numpy as jnp

    cfg = load_config(args.config)
    params = MDParams(
        temperature=cfg.md.temperature,
        dt=cfg.md.timestep_length,
        strain_rate=cfg.md.strain_rate,
        nsteps_sample=cfg.md.nsteps_sample,
    )
    outdir = args.outdir or cfg.dirs.nanoscale_input
    from .config import md_spec_kwargs

    spec_kw = md_spec_kwargs(cfg)  # effective ff + reax ffield path
    for mi, mat in enumerate(cfg.material.materials):
        stiffs, rhos = [], []
        for repl in range(1, cfg.material.number_of_replicas + 1):
            spec = M.MaterialSpec(name=mat, n_cells=args.cells, **spec_kw)
            sys_, st = M.build_system(spec)
            # same seed stream as build_md_hmm's inline prep (per material
            # AND per replica), so the two paths produce matching states
            key = jax.random.PRNGKey(cfg.seed + 101 * mi + (repl - 1))
            if not args.quick_prep:
                # in.init.lammps heatup/cooldown NPT cycle — the
                # production default, matching `run` (these init.* files
                # take precedence over on-device measurement)
                st = M.equilibrate_staged(sys_, st, params, key,
                                          ns_init=args.ns_init,
                                          minimize_steps=args.minimize_steps)
            else:
                st = M.equilibrate(sys_, st, params, key,
                                   minimize_steps=args.minimize_steps,
                                   equil_steps=args.equil_steps)
            data = M.measure(sys_, st, params)
            M.write_init_files(outdir, mat, repl, data)
            print(f"{mat}_{repl}: L={data.length[0]:.4f} A  rho={data.density:.1f} "
                  f"kg/m3  C11={data.stiff[0,0]/1e9:.3f} GPa  "
                  f"C12={data.stiff[0,1]/1e9:.3f} GPa  C44={data.stiff[3,3]/1e9:.3f} GPa")
            stiffs.append(data.stiff)
            rhos.append(data.density)
        # common-ground per-material averages (identity replica orientations)
        import os

        os.makedirs(outdir, exist_ok=True)
        cavg = np.mean(np.stack(stiffs), axis=0)
        io.write_sym4(f"{outdir}/init.{mat}.stiff",
                      np.asarray(T.c66_to_rank4(jnp.asarray(cavg))))
        io.write_scalar(f"{outdir}/init.{mat}.density", float(np.mean(rhos)))
        print(f"{mat}: wrote averaged init.{mat}.stiff / .density to {outdir}")
    return 0


def cmd_strain_md(args) -> int:
    """Standalone single-replica strained MD (strain_md.cc equivalent)."""
    import jax
    import numpy as np
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from .config import load_config
    from .md import material as M
    from .md.homogenization import MDParams, strain_and_homogenize

    cfg = load_config(args.config)
    params = MDParams(
        temperature=cfg.md.temperature,
        dt=cfg.md.timestep_length,
        strain_rate=cfg.md.strain_rate,
        nsteps_sample=cfg.md.nsteps_sample,
    )
    from .config import md_spec_kwargs

    spec = M.MaterialSpec(name=cfg.material.materials[0],
                          n_cells=args.cells, **md_spec_kwargs(cfg))
    sys_, st = M.build_system(spec)
    key = jax.random.PRNGKey(cfg.seed)
    st = M.equilibrate(sys_, st, params, key, minimize_steps=args.minimize_steps,
                       equil_steps=args.equil_steps)
    eps = jnp.asarray([float(x) for x in args.strain.split(",")])
    from .md import box as B

    L, _ = B.lengths_tilts(st.h)
    dlength = eps * jnp.stack([L[0], L[1], L[2], L[2], L[1], L[0]])
    st, stress = jax.jit(lambda s, d: strain_and_homogenize(sys_, s, d, params))(
        st, dlength
    )
    print("stress (Pa, Voigt xx yy zz xy xz yz):")
    print(" ".join(f"{float(s):.6e}" for s in stress))
    if args.save_state:
        from .hmm.checkpoint import save_checkpoint

        save_checkpoint(args.save_state, st)
        print(f"microstate saved to {args.save_state}")
    if args.dump:
        import numpy as np
        from .md.data_io import write_lammpstrj

        # the reference's microstate-dump column set (id type xs ys zs
        # vx vy vz ix iy iz, stmd_problem.h:262) so analyse-md can
        # re-homogenize the dump like anmd_problem.h:100-179 does
        # atom types live on the force field (opls.OPLSFF.types etc.),
        # not MDSystem; fall back to single-type when the ff has none
        ff_types = getattr(sys_.ff, "types", None)
        write_lammpstrj(args.dump, np.asarray(st.pos), np.asarray(st.h),
                        types=None if ff_types is None
                        else np.asarray(ff_types),
                        vel=np.asarray(st.vel), style="custom_scaled")
        print(f"microstate dump written to {args.dump}")
    return 0


def cmd_analyse_md(args) -> int:
    """Re-homogenize a saved MD microstate (analyse_md.cc equivalent)."""
    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from .config import load_config
    from .md import material as M
    from .md import engine as E
    from .md.homogenization import MDParams
    from .md.units import ATM_TO_PA
    from .hmm.checkpoint import load_checkpoint

    cfg = load_config(args.config)
    params = MDParams(
        temperature=cfg.md.temperature,
        dt=cfg.md.timestep_length,
        strain_rate=cfg.md.strain_rate,
        nsteps_sample=cfg.md.nsteps_sample,
    )
    from .config import md_spec_kwargs

    spec = M.MaterialSpec(name=cfg.material.materials[0],
                          n_cells=args.cells, **md_spec_kwargs(cfg))
    sys_, st0 = M.build_system(spec)
    if args.state.endswith((".dump", ".lammpstrj")):
        # reference-produced last.<qpid>.<mat>_<r>.dump text microstate
        # (stmd_problem.h:262, re-read by anmd_problem.h:100-179)
        from .md.data_io import read_lammps_dump

        frame = read_lammps_dump(args.state)
        if frame["pos"].shape[0] != st0.pos.shape[0]:
            print(f"error: dump has {frame['pos'].shape[0]} atoms but the "
                  f"config's material box has {st0.pos.shape[0]} — "
                  "match --cells / material to the dump's system",
                  file=sys.stderr)
            return 2
        st = st0._replace(
            pos=jnp.asarray(frame["pos"], st0.pos.dtype),
            vel=jnp.asarray(frame["vel"], st0.vel.dtype),
            h=jnp.asarray(frame["h"], st0.h.dtype),
        )
    else:
        st = load_checkpoint(args.state, st0)
    st, press = jax.jit(
        lambda s: E.sample_stress(sys_, s, params.nsteps_sample,
                                  params.temperature, params.dt)
    )(st)
    stress = -press * ATM_TO_PA
    print("re-homogenized stress (Pa, Voigt xx yy zz xy xz yz):")
    print(" ".join(f"{float(s):.6e}" for s in stress))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scema_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run the coupled HMM time loop")
    pr.add_argument("config", help="reference-format inputs.json")
    pr.add_argument("--steps", type=int, default=0, help="override number of steps")
    pr.add_argument("--hooke", action="store_true",
                    help="force 'approximate md with hookes law' debug mode")
    pr.add_argument("--cpu", action="store_true", help="run on CPU in float64")
    pr.add_argument("--outdir", default="", help="write VTK/CSV/checkpoints here")
    pr.add_argument("--restart", default="", help="restore from a checkpoint npz")
    pr.add_argument("--restart-reference", default="",
                    help="restore from a reference-produced lcts.* restart dir")
    pr.add_argument("--profile", default="",
                    help="capture a jax.profiler trace of the run to this dir")
    pr.add_argument("--max-jobs", type=int, default=0,
                    help="cap the static MD job-list capacity")
    pr.add_argument("--surrogate", default="",
                    help="stress method 2: path to a Keras surrogate .bin "
                         "(or its directory with scaler.pkl)")
    pr.add_argument("--max-retries", type=int, default=3,
                    help="transient-fault retries (rollback to the last "
                         "good step)")
    pr.add_argument("--dump-similarity", default="",
                    help="write the final strain-history L2 distance matrix "
                         "as an npz (dist, threshold) for "
                         "clustering.render_network")
    pr.add_argument("--quick-prep", action="store_true",
                    help="short fixed-box material prep instead of the "
                         "staged heatup/cooldown NPT cycle")
    pr.set_defaults(fn=cmd_run)

    pi = sub.add_parser("init-material", help="equilibrate materials, measure stiffness")
    pi.add_argument("config")
    pi.add_argument("--cells", type=int, default=3, help="lattice cells per dim")
    pi.add_argument("--minimize-steps", type=int, default=100)
    pi.add_argument("--equil-steps", type=int, default=200)
    pi.add_argument("--quick-prep", action="store_true",
                    help="short fixed-box prep instead of the staged "
                         "heatup/cooldown NPT cycle (debug/smoke runs)")
    pi.add_argument("--ns-init", type=int, default=100,
                    help="stage length unit for staged prep (in.init nsinit)")
    pi.add_argument("--outdir", default="")
    pi.add_argument("--cpu", action="store_true")
    pi.set_defaults(fn=cmd_init_material)

    ps = sub.add_parser("strain-md", help="single strained MD run (strain_md analog)")
    ps.add_argument("config")
    ps.add_argument("--strain", default="0.002,0,0,0,0,0",
                    help="Voigt strain xx,yy,zz,xy,xz,yz")
    ps.add_argument("--cells", type=int, default=3)
    ps.add_argument("--minimize-steps", type=int, default=100)
    ps.add_argument("--equil-steps", type=int, default=100)
    ps.add_argument("--save-state", default="")
    ps.add_argument("--dump", default="", help="write a .lammpstrj frame")
    ps.add_argument("--cpu", action="store_true")
    ps.set_defaults(fn=cmd_strain_md)

    pa = sub.add_parser("analyse-md", help="re-homogenize a saved microstate")
    pa.add_argument("config")
    pa.add_argument("state", help="microstate checkpoint (npz)")
    pa.add_argument("--cells", type=int, default=3)
    pa.add_argument("--cpu", action="store_true")
    pa.set_defaults(fn=cmd_analyse_md)

    args = p.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
