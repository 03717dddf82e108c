"""scema_tpu — a Heterogeneous Multiscale Method (HMM) framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of UCL-CCS/SCEMa
(``dealammps``): a continuum finite-element solid-mechanics solver whose
constitutive law is evaluated on demand by batched molecular-dynamics
microsimulations at the quadrature points, together with replica ensembles,
strain-history similarity clustering, surrogate stress models, material
initialization, checkpointing, and VTK observability.

Where the reference (UCL-CCS/SCEMa, cited per-module as file:line)
couples deal.II + PETSc + LAMMPS + Python over MPI ranks and the filesystem,
this framework is a single SPMD JAX program: the FE update is matrix-free,
the MD engine is a vmapped/shard_mapped on-device kernel, and all
scale-bridging data stays in device memory.

Subpackages
-----------
config      : JSON configuration schema (mirrors docs/configuration.md)
utils       : tensor math (Voigt/rank-4/rotations), file IO, logging
fem         : macroscale explicit-dynamics FE solver (Q1 hexes, matrix-free)
md          : batched on-device MD engine (LJ / SW / OPLS force fields)
bridging    : FE<->MD scale bridging, Hooke debug backend, surrogate model
clustering  : strain-history splines, pairwise-L2 similarity, graph reduction
parallel    : device-mesh sharding helpers and the padded job dispatcher
hmm         : the top-level coupled HMM time loop and checkpointing
"""

__version__ = "0.1.0"

# On an NVIDIA GPU, float32 dot/einsum run in TF32 (about three decimal
# digits) unless told otherwise, which corrupts MD geometry (box
# transforms, bond angles), PME charge spreading and FE assembly far
# beyond float32 roundoff.  This framework is numerical software:
# full-precision matmul arithmetic is the only correct default.  Hot
# kernels that can tolerate lower precision opt in explicitly.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")
