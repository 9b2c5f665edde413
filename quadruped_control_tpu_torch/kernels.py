"""Build and load the hand-written CUDA kernels (csrc/) and launch them.

The kernels are compiled at FIRST USE with ``nvcc`` for ``sm_90a`` from the
sources in ``csrc/`` and nothing else: each ``.cu`` file is compiled to an
object file by its own ``nvcc`` process (all started together), the objects
are linked into one shared library with a plain C interface, and the library
is loaded with ``ctypes``. The build lands in ``_build/<hash of the
sources and flags>/`` beside this file (git-ignored). A failed build or a
failed launch raises; nothing here gives way to the plain PyTorch versions.

Each launcher below checks its tensors, allocates the outputs with
``torch.empty``, launches on ``torch.cuda.current_stream()`` without
synchronising, raises if the C entry reports a CUDA error, and adds one to
its entry of ``launch_counts`` — there and nowhere else.

Compile flags: ``-fmad=false`` keeps ``a*b + c`` as two rounded operations,
so the kernels follow their plain PyTorch versions operation for operation
and the Dekker error-free transformations stay exact; never
``--use_fast_math`` (it breaks the division, square root and NaN handling the
certificate rests on).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent / "_build"
_SOURCES = ("qct_assemble.cu", "qct_fused_barrier.cu", "qct_fused_polish.cu",
            "qct_commander.cu", "qct_substep.cu", "qct_mpc.cu",
            "qct_dense_ipm.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

# Launches of each kernel since the last reset (plain integers).
launch_counts = {"qct_fused_solve": 0, "qct_assemble": 0,
                 "qct_commander_pre": 0, "qct_commander_serial": 0,
                 "qct_substep": 0,
                 "qct_substep_serial": 0, "qct_mpc_riccati": 0,
                 "qct_mpc_serial": 0,
                 "qct_dense_barrier": 0, "qct_dense_polish": 0}

# The compiler's resource report (-Xptxas -v) of the build this process made
# ("" when the library of an earlier build was loaded).
last_build_log = ""

_lib = None
_lock = threading.Lock()


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def refuse_grad(entry: str, *tensors):
    """Raise when autograd would need a gradient through a kernel entry.

    The kernels (and, to match, their plain versions) have no backward, as
    their Pallas counterparts have none: without this check a loss would get
    a silent zero gradient through them. ``None`` entries are skipped."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{entry}: a kernel backend has no backward; differentiate "
            f"through qp_backend='jnp' or mpc_backend='structured' / "
            f"'condensed' instead")


class FusedParams(ctypes.Structure):
    """Mirror of ``QctParams`` in csrc/qct_common.cuh (same order)."""

    _fields_ = [
        ("sl", ctypes.c_float * 3),
        ("sa", ctypes.c_float * 3),
        ("w2", ctypes.c_float),
        ("swing_relax", ctypes.c_float),
        ("tau", ctypes.c_float),
        ("tol", ctypes.c_float),
        ("prox_rho", ctypes.c_float),
        ("iterations", ctypes.c_int),
        ("polish", ctypes.c_int),
        ("sweeps", ctypes.c_int),
        ("refine", ctypes.c_int),
        ("multi_swap", ctypes.c_int),
        ("warm_mode", ctypes.c_int),   # 0 cold, 3 polish-only, 4 warm barrier
        ("prox_steps", ctypes.c_int),
        ("prox_iterations", ctypes.c_int),
        ("prox_sweeps", ctypes.c_int),
        ("prox_cold", ctypes.c_int),
        ("ff_refine", ctypes.c_int),
        ("equilibrated", ctypes.c_int),
    ]


_F = ctypes.c_float


class CommanderParams(ctypes.Structure):
    """Mirror of ``QctCmdParams`` in csrc/qct_commander.cuh (same order)."""

    _fields_ = [
        ("hips", _F * 12), ("l1s", _F * 4),
        ("l1", _F), ("l2", _F), ("l3", _F), ("sl2", _F), ("sl3", _F),
        ("l1_sq", _F), ("ik_sum", _F), ("inv_ik_den", _F),
        ("dt", _F), ("dt_cmd", _F), ("stand_h", _F), ("stand_tol", _F),
        ("inv_period", _F), ("stance_thresh", _F), ("half_t_stance", _F),
        ("swing_height", _F), ("offsets", _F * 4),
        ("slope", _F), ("intercept", _F),
        ("fp_hips", _F * 12), ("fp_k", _F), ("inv_fp_g", _F),
        ("kp_j", _F * 3), ("kd_j", _F * 3), ("kff_j", _F * 3),
        ("mass", _F), ("inertia", _F * 3),
        ("kp_p", _F * 3), ("kd_p", _F * 3), ("kp_w", _F * 3),
        ("kd_w", _F * 3), ("kff", _F * 6),
        ("kff_mg", _F), ("gravity_z", _F), ("mu", _F), ("fz_min", _F),
        ("fz_max", _F), ("a_inv", _F * 21),
        ("contact_gate", _F), ("raibert_cmd_symmetric", ctypes.c_int),
        ("mpc_horizon", ctypes.c_int), ("mpc_dt", ctypes.c_double),
    ]


class SubstepParams(ctypes.Structure):
    """Mirror of ``QctSubParams`` in csrc/qct_substep.cuh (same order)."""

    _fields_ = [
        ("trunk_m", _F), ("trunk_I", _F * 3), ("link_m", _F * 12),
        ("link_c", _F * 36), ("link_I", _F * 36), ("leaf_h", _F * 36),
        ("leaf_J", _F * 108), ("joint_r", _F * 36), ("damp", _F * 12),
        ("armature", _F * 12), ("hips", _F * 12), ("l1s", _F * 4),
        ("sl2", _F), ("sl3", _F),
        ("k_n", _F), ("d_n", _F), ("mu", _F), ("kt", _F), ("ct", _F),
        ("v_s", _F), ("trunk_cz", _F),
        ("tau_min", _F), ("tau_max", _F), ("gravity", _F),
        ("use_anchor", ctypes.c_int), ("torque_qp", ctypes.c_int),
        ("gravity_comp", ctypes.c_int), ("prefactor_kernel", ctypes.c_int),
    ]


class MpcParams(ctypes.Structure):
    """Mirror of ``QctMpcParams`` in csrc/qct_mpc.cuh (same order)."""

    _fields_ = [
        ("n_steps", ctypes.c_int), ("iterations", ctypes.c_int),
        ("track_best", ctypes.c_int),
        ("dt", _F), ("sfdt", _F), ("g_dt", _F), ("r_alpha", _F),
        ("sigma_c", _F), ("tau", _F), ("tol", _F), ("relax", _F), ("sf", _F),
        ("w", _F * 13),
        ("mass", _F), ("inertia", _F * 3), ("mu", _F), ("fz_min", _F),
        ("fz_max", _F),
    ]


# Scratch words per horizon step and robot of the MPC kernel (F, s, z,
# residuals, right-hand side, c, h, best F, feed-forward, gains).
MPC_WORDS_PER_STEP = 324
# Robots a block of the MPC kernel runs. Its lanes per robot, thread limit
# and shared words per robot are the build's (mpc_layout).
MPC_ROBOTS_PER_BLOCK = 8
# Shared memory one block may hold on a Hopper card (227 KB).
SHARED_BYTES_MAX = 232448


class MpcLayout(NamedTuple):
    """What a build of a kernel that runs one robot on a group of lanes
    reports (the MPC kernel's csrc/qct_mpc.cuh ``qmpc_layout``, the substep
    kernel's csrc/qct_substep.cuh ``qs_layout``): lanes per robot, threads a
    block at most (its ``__launch_bounds__``), words of shared memory per
    robot."""

    lanes: int
    max_threads: int
    shared_words: int


class MpcGeometry(NamedTuple):
    """Launch of a lane-group robot kernel (the MPC kernel, the substep
    kernel): robot slot ``blockIdx.x * robots_per_block + threadIdx.x //
    lanes`` (slots past B run along and write no output)."""

    blocks: int
    threads: int
    robots_per_block: int
    shared_bytes: int


def mpc_launch_geometry(B: int, layout: MpcLayout) -> MpcGeometry:
    """The MPC kernel's launch for B robots: blocks of MPC_ROBOTS_PER_BLOCK
    robots, each with ``layout.lanes`` threads and its shared words (which
    do not grow with the horizon). Raises where such a block does not fit
    the build or the card: more threads than the kernel is compiled for, or
    more shared memory than a Hopper block has."""
    threads = MPC_ROBOTS_PER_BLOCK * layout.lanes
    shared = MPC_ROBOTS_PER_BLOCK * layout.shared_words * 4
    if threads > layout.max_threads or shared > SHARED_BYTES_MAX:
        raise ValueError(
            f"{MPC_ROBOTS_PER_BLOCK} robots a block need {threads} threads "
            f"and {shared} bytes of shared memory; the kernel is compiled "
            f"for {layout.max_threads} threads and a block has "
            f"{SHARED_BYTES_MAX} bytes")
    return MpcGeometry(-(-B // MPC_ROBOTS_PER_BLOCK), threads,
                       MPC_ROBOTS_PER_BLOCK, shared)


class FusedLayout(NamedTuple):
    """What a build of a kernel that runs one QP on a group of lanes reports
    (the fused kernel's csrc/qct_fused.cuh ``qf_layout``, the dense
    barrier's and polish's csrc/qct_dense_ipm.cuh ``qdb_layout`` and
    ``qd_layout``): lanes per QP, threads a block at most (its
    ``__launch_bounds__``), words of shared memory per QP."""

    lanes: int
    max_threads: int
    shared_words: int


class FusedGeometry(NamedTuple):
    """Launch of a lane-group QP kernel (the fused kernel, the dense
    barrier and polish): QP slot ``blockIdx.x * qps_per_block +
    threadIdx.x // lanes`` (slots past B run along and write no output)."""

    blocks: int
    threads: int
    qps_per_block: int
    shared_bytes: int


def fused_launch_geometry(B: int, layout: FusedLayout) -> FusedGeometry:
    """The fused kernel's launch for B QPs (and the dense barrier's, K3a, on
    :func:`dense_barrier_layout`): blocks of the build's full thread count,
    ``layout.lanes`` threads and ``layout.shared_words`` of shared memory
    per QP. Raises where such a block does not fit a Hopper
    block's shared memory or is not made of whole warps."""
    qps = layout.max_threads // layout.lanes
    threads = qps * layout.lanes
    shared = qps * layout.shared_words * 4
    if qps < 1 or threads % 32 != 0 or shared > SHARED_BYTES_MAX:
        raise ValueError(
            f"{qps} QPs a block of {threads} threads need {shared} bytes of "
            f"shared memory; a block has {SHARED_BYTES_MAX} bytes and whole "
            f"warps")
    return FusedGeometry(-(-B // qps), threads, qps, shared)


def substep_launch_geometry(B: int, layout: MpcLayout) -> MpcGeometry:
    """The substep kernel's (K5) launch for B robots on its build's layout
    (:func:`substep_layout`): blocks of the build's full thread count,
    ``layout.lanes`` threads and ``layout.shared_words`` of shared memory per
    robot (the model parameters' copy, ``SubstepParams``, is the kernel's
    static shared memory). Raises where such a block is not made of whole
    warps or does not fit a Hopper block's shared memory."""
    robots = layout.max_threads // layout.lanes
    threads = robots * layout.lanes
    shared = robots * layout.shared_words * 4
    if (robots < 1 or threads % 32 != 0 or
            shared + ctypes.sizeof(SubstepParams) > SHARED_BYTES_MAX):
        raise ValueError(
            f"{robots} robots a block of {threads} threads need {shared} "
            f"bytes of shared memory and the model's "
            f"{ctypes.sizeof(SubstepParams)}; a block has "
            f"{SHARED_BYTES_MAX} bytes and whole warps")
    return MpcGeometry(-(-B // robots), threads, robots, shared)


def dense_launch_geometry(B: int, layout: FusedLayout) -> FusedGeometry:
    """The dense polish kernel's (K3b) launch for B QPs on its build's
    layout (:func:`dense_polish_layout`): the fused kernel's rule, blocks of
    the build's full thread count, ``layout.lanes`` threads and
    ``layout.shared_words`` of shared memory per QP."""
    return fused_launch_geometry(B, layout)


def _fill(struct, values: dict):
    """Copy Python floats / sequences / arrays into a ctypes struct (each
    value is rounded to the field's type by ctypes)."""
    for name, ctype in struct._fields_:
        v = values[name]
        if hasattr(ctype, "_length_"):
            flat = [float(e) for e in _flatten(v)]
            if len(flat) != ctype._length_:
                raise ValueError(f"{name}: {len(flat)} values for "
                                 f"{ctype._length_}")
            setattr(struct, name, ctype(*flat))
        else:
            setattr(struct, name, int(v) if ctype is ctypes.c_int else float(v))
    return struct


def _flatten(v):
    if hasattr(v, "ravel"):
        return v.ravel().tolist()
    out = []
    for e in v:
        out.extend(_flatten(e) if hasattr(e, "__len__") else [e])
    return out


def commander_params(c, contact_gate, raibert_cmd_symmetric, mpc_horizon=0,
                     mpc_dt=0.0):
    """``control.fused_commander.CommanderConsts`` -> CommanderParams."""
    values = {name: getattr(c, name, None)
              for name, _ in CommanderParams._fields_}
    values.update(l1_sq=c.l1 * c.l1, a_inv=c.a_inv[:, 0:3],
                  contact_gate=contact_gate,
                  raibert_cmd_symmetric=int(raibert_cmd_symmetric),
                  mpc_horizon=int(mpc_horizon), mpc_dt=float(mpc_dt))
    return _fill(CommanderParams(), values)


def mpc_params(st):
    """``mpc.fused_riccati.MpcSettings`` -> MpcParams. Products of Python
    floats are formed in double and rounded once. Robot constants that the
    settings leave None are zeros (the launch then takes them per instance
    from ``phys``)."""
    from quadruped_control_tpu_torch.config import GRAVITY
    from quadruped_control_tpu_torch.mpc.fused_riccati import SIGMA_F
    from quadruped_control_tpu_torch.ops.dynamics import SWING_ROW_RELAX

    def opt(v, n=None):
        if v is None:
            return 0.0 if n is None else [0.0] * n
        return v

    return _fill(MpcParams(), dict(
        n_steps=st.n_steps, iterations=st.iterations,
        track_best=int(st.track_best), dt=st.dt, sfdt=SIGMA_F * st.dt,
        g_dt=GRAVITY * st.dt, r_alpha=SIGMA_F * SIGMA_F * st.alpha,
        sigma_c=st.sigma_c, tau=st.tau, tol=st.tol, relax=SWING_ROW_RELAX,
        sf=SIGMA_F, w=st.state_weights, mass=opt(st.mass),
        inertia=opt(st.inertia_diag, 3), mu=opt(st.mu),
        fz_min=opt(st.fz_min), fz_max=opt(st.fz_max)))


def substep_params(c):
    """``sim.fused_substep.SubstepConsts`` -> SubstepParams."""
    return _fill(SubstepParams(), c._asdict())


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels cannot be built on this machine")
    return exe


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into ``_build/<hash>/libqct_kernels.so`` (if that file
    is not there yet) and return its path."""
    global last_build_log
    out_dir = _BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libqct_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *_NVCC_FLAGS, "-Xptxas", "-v", "-c",
               str(_CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs = [], []
    failed = None
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0 and failed is None:
            failed = (src, out)
    last_build_log = "\n".join(logs)
    if failed is not None:
        raise RuntimeError(f"nvcc failed on {failed[0]}:\n{failed[1]}")
    tmp = out_dir / f"libqct_kernels.{os.getpid()}.tmp.so"
    link = subprocess.run(
        [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def load():
    """The loaded library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.qct_fused_solve.argtypes = [vp] * 15 + [
                ci, ci, ci, ci, ctypes.POINTER(FusedParams), vp]
            lib.qct_fused_solve.restype = ci
            lib.qct_assemble.argtypes = [vp] * 10 + [
                ci, ctypes.POINTER(FusedParams), vp]
            lib.qct_assemble.restype = ci
            lib.qct_commander_pre.argtypes = [vp] * 13 + [
                ci, ctypes.POINTER(CommanderParams), ci, ci, vp]
            lib.qct_commander_pre.restype = ci
            lib.qct_commander_serial.argtypes = [vp] * 13 + [
                ci, ctypes.POINTER(CommanderParams), vp]
            lib.qct_commander_serial.restype = ci
            lib.qct_commander_serial_block.argtypes = [ci]
            lib.qct_commander_serial_block.restype = ci
            lib.qct_commander_layout.argtypes = [vp]
            lib.qct_commander_layout.restype = ci
            lib.qct_substep.argtypes = [vp] * 6 + [
                ci, ci, ctypes.c_float, ctypes.POINTER(SubstepParams), ci, ci,
                ci, vp]
            lib.qct_substep.restype = ci
            lib.qct_substep_serial.argtypes = [vp] * 6 + [
                ci, ci, ctypes.c_float, ctypes.POINTER(SubstepParams), vp]
            lib.qct_substep_serial.restype = ci
            lib.qct_substep_layout.argtypes = [vp]
            lib.qct_substep_layout.restype = ci
            lib.qct_mpc_riccati.argtypes = [vp] * 10 + [
                ci, ci, ci, ci, ctypes.POINTER(MpcParams), vp]
            lib.qct_mpc_riccati.restype = ci
            lib.qct_mpc_serial.argtypes = [vp] * 10 + [
                ci, ctypes.POINTER(MpcParams), vp]
            lib.qct_mpc_serial.restype = ci
            lib.qct_mpc_layout.argtypes = [vp]
            lib.qct_mpc_layout.restype = ci
            lib.qct_fused_layout.argtypes = [vp]
            lib.qct_fused_layout.restype = ci
            lib.qct_dense_polish_layout.argtypes = [vp]
            lib.qct_dense_polish_layout.restype = ci
            lib.qct_dense_barrier_layout.argtypes = [vp]
            lib.qct_dense_barrier_layout.restype = ci
            for fn in ("qct_mpc_fn", "qct_fused_barrier_fn",
                       "qct_fused_polish_fn", "qct_dense_barrier_fn",
                       "qct_dense_polish_fn", "qct_substep_fn",
                       "qct_commander_fn", "qct_commander_serial_fn"):
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = vp
            lib.qct_occupancy.argtypes = [vp, ci, ci, vp]
            lib.qct_occupancy.restype = ci
            lib.qct_dense_barrier.argtypes = [vp] * 7 + [
                ci, ci, ctypes.c_float, ci, ci, ci, vp]
            lib.qct_dense_barrier.restype = ci
            lib.qct_dense_polish.argtypes = [vp] * 11 + [ci, ci, ci, ci,
                                                          vp]
            lib.qct_dense_polish.restype = ci
            lib.qct_error_string.argtypes = [ci]
            lib.qct_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _f32(v: float) -> float:
    """Round a Python float to float32 (what a kernel argument holds)."""
    return float(torch.tensor(v, dtype=torch.float32))


def _params(s_diag, w_diag, swing_relax, **kw) -> FusedParams:
    p = FusedParams()
    for k in range(3):
        p.sl[k] = _f32(2.0 * s_diag[k])
        p.sa[k] = _f32(s_diag[3 + k])
    p.w2 = _f32(2.0 * w_diag)
    p.swing_relax = swing_relax
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _require_cuda(name, a, k, B, device):
    if (not torch.is_tensor(a) or a.device != device
            or device.type != "cuda" or a.dtype != torch.float32
            or tuple(a.shape) != (k, B) or not a.is_contiguous()):
        raise ValueError(
            f"{name}: the kernel takes a contiguous float32 CUDA tensor of "
            f"shape ({k}, {B}) on {device}; got "
            f"{getattr(a, 'dtype', type(a))} {tuple(getattr(a, 'shape', ()))} "
            f"on {getattr(a, 'device', None)}")


def _check(lib, rc, what):
    if rc != 0:
        msg = lib.qct_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


def fused_solve(rp, bp, stp, mup, fminp, fmaxp, warm, sched, work=None):
    """Launch the fused GRF-QP kernel (K1) once on ``(k, B)`` CUDA tensors.
    ``sched`` is a ``solver.fused.FusedSchedule``; ``warm`` is (), (x, s, z)
    or (x, s, z, st_prev). Returns (x, s, z, diag).

    ``work``: optional int32 ``(2, B)`` CUDA tensor the kernel fills with
    the barrier iterations and the polish sweeps each instance ran (a
    certified QP stops sweeping early) — for operation counts. The launch
    takes :func:`fused_launch_geometry` (a group of lanes per QP)."""
    device = rp.device
    B = rp.shape[1]
    for name, a, k in (("rp", rp, 12), ("bp", bp, 6), ("stp", stp, 4),
                       ("mup", mup, 1), ("fminp", fminp, 1),
                       ("fmaxp", fmaxp, 1)):
        _require_cuda(name, a, k, B, device)
    for name, a, k in zip(("xw", "sw", "zw", "st_prev"), warm,
                          (12, 24, 24, 4)):
        _require_cuda(name, a, k, B, device)
    if work is not None and (
            work.device != device or work.dtype != torch.int32
            or tuple(work.shape) != (2, B) or not work.is_contiguous()):
        raise ValueError(f"work: expected contiguous int32 (2, {B}) on "
                         f"{device}")
    lib = load()
    psw = sched.polish_sweeps if sched.prox_sweeps is None else sched.prox_sweeps
    p = _params(
        sched.s_diag, sched.w_diag, sched.swing_relax, tau=sched.tau,
        tol=sched.tol, prox_rho=sched.prox_rho, iterations=sched.iterations,
        polish=int(sched.polish), sweeps=sched.polish_sweeps,
        refine=sched.polish_refine, multi_swap=int(sched.polish_multi_swap),
        warm_mode=len(warm), prox_steps=sched.prox_steps,
        prox_iterations=sched.prox_iterations, prox_sweeps=psw,
        prox_cold=int(sched.prox_cold), ff_refine=int(sched.ff_refine))
    x = torch.empty((12, B), dtype=torch.float32, device=device)
    s = torch.empty((24, B), dtype=torch.float32, device=device)
    z = torch.empty((24, B), dtype=torch.float32, device=device)
    diag = torch.empty((6, B), dtype=torch.float32, device=device)
    wptr = [a.data_ptr() for a in warm] + [None] * (4 - len(warm))
    geo = fused_launch_geometry(B, fused_layout())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_fused_solve(
            rp.data_ptr(), bp.data_ptr(), stp.data_ptr(), mup.data_ptr(),
            fminp.data_ptr(), fmaxp.data_ptr(), *wptr,
            x.data_ptr(), s.data_ptr(), z.data_ptr(), diag.data_ptr(),
            None if work is None else work.data_ptr(),
            B, geo.blocks, geo.threads, geo.shared_bytes, ctypes.byref(p),
            stream)
    _check(lib, rc, "qct_fused_solve")
    launch_counts["qct_fused_solve"] += 1
    return x, s, z, diag


def assemble(rp, bp, stp, mup, fminp, fmaxp, *, s_diag, w_diag, swing_relax,
             equilibrated):
    """Launch the assembly kernel (K2) once on ``(k, B)`` CUDA tensors.
    Returns dense (Q (144,B), c (12,B), G (288,B), h (24,B))."""
    device = rp.device
    B = rp.shape[1]
    for name, a, k in (("rp", rp, 12), ("bp", bp, 6), ("stp", stp, 4),
                       ("mup", mup, 1), ("fminp", fminp, 1),
                       ("fmaxp", fmaxp, 1)):
        _require_cuda(name, a, k, B, device)
    lib = load()
    p = _params(s_diag, w_diag, swing_relax, equilibrated=int(equilibrated))
    Q = torch.empty((144, B), dtype=torch.float32, device=device)
    c = torch.empty((12, B), dtype=torch.float32, device=device)
    G = torch.empty((288, B), dtype=torch.float32, device=device)
    h = torch.empty((24, B), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_assemble(
            rp.data_ptr(), bp.data_ptr(), stp.data_ptr(), mup.data_ptr(),
            fminp.data_ptr(), fmaxp.data_ptr(),
            Q.data_ptr(), c.data_ptr(), G.data_ptr(), h.data_ptr(),
            B, ctypes.byref(p), stream)
    _check(lib, rc, "qct_assemble")
    launch_counts["qct_assemble"] += 1
    return Q, c, G, h


# Rows of the commander-pre kernel's outputs in its one output slab:
# r | b | st | mu | fz_min | fz_max | tau_swing | carry | q_ref.
_CMD_OUT_ROWS = (12, 6, 4, 1, 1, 1, 12, 95, 12)


def _commander_args(state, carry, cmd, params):
    """Check K4's tensors; returns (B, device, the output slab's row
    blocks)."""
    device = state.device
    B = state.shape[1]
    _require_cuda("state", state, state.shape[0], B, device)
    if state.shape[0] < 42:
        raise ValueError(f"state: {state.shape[0]} rows, the kernel reads 42")
    _require_cuda("carry", carry, 95, B, device)
    _require_cuda("cmd", cmd, 6, B, device)
    rows = _CMD_OUT_ROWS
    if params.mpc_horizon > 0:
        rows = rows + (25 + 17 * params.mpc_horizon,)
    slab = torch.empty((sum(rows), B), dtype=torch.float32, device=device)
    return B, device, torch.split(slab, rows)


def commander_pre(state, carry, cmd, params):
    """Launch the commander-pre kernel (K4) once on ``(k, B)`` CUDA tensors:
    ``state`` (>= 42, B), ``carry`` (95, B), ``cmd`` (6, B); ``params`` is a
    :class:`CommanderParams` (see :func:`commander_params`). Returns (r, b,
    st, mu, fz_min, fz_max, tau_swing, carry, q_ref), contiguous row blocks
    of ONE allocation, and with ``params.mpc_horizon = N > 0`` a tenth block,
    the MPC precursor block (25 + 17 N, B). The launch takes
    :func:`commander_geometry` (a group of lanes per instance)."""
    B, device, outs = _commander_args(state, carry, cmd, params)
    lib = load()
    geo = commander_geometry(B)
    ptrs = [o.data_ptr() for o in outs] + [None] * (10 - len(outs))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_commander_pre(
            state.data_ptr(), carry.data_ptr(), cmd.data_ptr(), *ptrs, B,
            ctypes.byref(params), geo.blocks, geo.threads, stream)
    _check(lib, rc, "qct_commander_pre")
    launch_counts["qct_commander_pre"] += 1
    return outs


def commander_serial(state, carry, cmd, params):
    """Launch K4's serial body (one instance per thread, the kernel's first
    form) once, with :func:`commander_pre`'s arguments and outputs. It is
    the reference that chip_smoke.py holds K4 to bit for bit; no path of the
    port calls it. Counted under ``launch_counts["qct_commander_serial"]``.
    """
    B, device, outs = _commander_args(state, carry, cmd, params)
    lib = load()
    ptrs = [o.data_ptr() for o in outs] + [None] * (10 - len(outs))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_commander_serial(
            state.data_ptr(), carry.data_ptr(), cmd.data_ptr(), *ptrs, B,
            ctypes.byref(params), stream)
    _check(lib, rc, "qct_commander_serial")
    launch_counts["qct_commander_serial"] += 1
    return outs


def _substep_args(state, extras, factor, params):
    """Check K5's tensors; returns (B, device, the pointers of state, a,
    tau_swing, st and factor, None where a tensor is not taken)."""
    device = state.device
    B = state.shape[1]
    _require_cuda("state", state, 58, B, device)
    widths = (12, 12, 4) if params.torque_qp else (12,)
    if len(extras) != len(widths):
        raise ValueError(f"expected {len(widths)} torque inputs, got "
                         f"{len(extras)}")
    for name, a, k in zip(("a", "tau_swing", "st"), extras, widths):
        _require_cuda(name, a, k, B, device)
    if params.prefactor_kernel:
        if factor is not None:
            raise ValueError("factor given but the kernel builds its own")
    else:
        _require_cuda("factor", factor, 216, B, device)
    ptrs = ([state.data_ptr()] + [a.data_ptr() for a in extras]
            + [None] * (3 - len(extras))
            + [None if factor is None else factor.data_ptr()])
    return B, device, ptrs


def substep(state, extras, factor, params, n_substeps, h):
    """Launch the substep kernel (K5) once on ``(k, B)`` CUDA tensors:
    ``state`` (58, B); ``extras`` = (fw (12, B), tau_swing (12, B), st (4,
    B)) when ``params.torque_qp`` else (tau (12, B),); ``factor`` (216, B)
    unless ``params.prefactor_kernel``. ``params`` is a
    :class:`SubstepParams` (see :func:`substep_params`). Returns the new
    state (58, B). The launch takes :func:`substep_launch_geometry` (a
    group of lanes per robot)."""
    B, device, ptrs = _substep_args(state, extras, factor, params)
    lib = load()
    geo = substep_launch_geometry(B, substep_layout())
    out = torch.empty((58, B), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_substep(*ptrs, out.data_ptr(), B, int(n_substeps),
                             float(h), ctypes.byref(params), geo.blocks,
                             geo.threads, geo.shared_bytes, stream)
    _check(lib, rc, "qct_substep")
    launch_counts["qct_substep"] += 1
    return out


def substep_serial(state, extras, factor, params, n_substeps, h):
    """Launch K5's serial body (one robot per thread, the kernel's first
    form) once, with :func:`substep`'s arguments. It is the reference that
    chip_smoke.py holds K5 to bit for bit; no path of the port calls it.
    Counted under ``launch_counts["qct_substep_serial"]``."""
    B, device, ptrs = _substep_args(state, extras, factor, params)
    lib = load()
    out = torch.empty((58, B), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_substep_serial(*ptrs, out.data_ptr(), B,
                                    int(n_substeps), float(h),
                                    ctypes.byref(params), stream)
    _check(lib, rc, "qct_substep_serial")
    launch_counts["qct_substep_serial"] += 1
    return out


def _mpc_args(block, yaw, phys, warm, params, n_steps):
    """Check K6's tensors; returns (N, B, device, F, diag, warm_out, the
    pointers of yaw, phys and warm)."""
    N = int(n_steps)
    if params.n_steps != N:
        raise ValueError(f"params are for N = {params.n_steps}, not {N}")
    device = block.device
    B = block.shape[1]
    _require_cuda("block", block, 25 + 17 * N, B, device)
    if yaw is not None and (yaw.device != device or yaw.dtype != torch.float32
                            or tuple(yaw.shape) != (B,)
                            or not yaw.is_contiguous()):
        raise ValueError(f"yaw: expected contiguous float32 ({B},) on "
                         f"{device}")
    if phys is not None:
        _require_cuda("phys", phys, 7, B, device)
    if phys is None and params.mass == 0.0:
        raise ValueError("no robot constants: give phys or set them in params")
    if warm is not None:
        for name, a, k in zip(("warm F", "warm sz", "warm schedule"), warm,
                              (12 * N, 48 * N, 4 * N)):
            _require_cuda(name, a, k, B, device)
    F = torch.empty((12 * N, B), dtype=torch.float32, device=device)
    diag = torch.empty((6, B), dtype=torch.float32, device=device)
    wout = (None if warm is None else
            torch.empty((60 * N, B), dtype=torch.float32, device=device))
    ptrs = ([None if yaw is None else yaw.data_ptr(),
             None if phys is None else phys.data_ptr()]
            + ([None] * 3 if warm is None else [a.data_ptr() for a in warm]))
    return N, B, device, F, diag, wout, ptrs


def mpc_riccati(block, yaw, phys, warm, params, n_steps):
    """Launch the MPC kernel (K6) once on ``(k, B)`` CUDA tensors: ``block``
    (25 + 17N, B) = xi0 | levers | schedule | reference; ``yaw`` (B,) or
    None (then xi0[2]); ``phys`` (7, B) = [m, Ib, mu, fz_min, fz_max] or None
    (then the constants of ``params``); ``warm`` None or (F (12N, B), [s | z]
    (48N, B), schedule (4N, B)). ``params`` is an :class:`MpcParams` (see
    :func:`mpc_params`). Returns (F (12N, B), diag (6, B), [s | z | F] (60N,
    B) or None). The kernel's scratch, 324 N words per robot slot of the
    grid, is allocated here; the launch takes :func:`mpc_launch_geometry`."""
    N, B, device, F, diag, wout, ptrs = _mpc_args(block, yaw, phys, warm,
                                                  params, n_steps)
    lib = load()
    geo = mpc_launch_geometry(B, mpc_layout())
    scratch = torch.empty((geo.blocks * geo.robots_per_block,
                           MPC_WORDS_PER_STEP * N), dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_mpc_riccati(
            block.data_ptr(), *ptrs, F.data_ptr(), diag.data_ptr(),
            None if wout is None else wout.data_ptr(), scratch.data_ptr(),
            B, geo.blocks, geo.threads, geo.shared_bytes,
            ctypes.byref(params), stream)
    _check(lib, rc, "qct_mpc_riccati")
    launch_counts["qct_mpc_riccati"] += 1
    return F, diag, wout


def mpc_serial(block, yaw, phys, warm, params, n_steps):
    """Launch K6's serial body (``qct_mpc_serial``: one robot per thread,
    the arithmetic of the kernel before its lane split) on the arguments of
    :func:`mpc_riccati`, with the same return. No path of the port calls
    it: ``chip_smoke.py`` holds the lane kernel bitwise to it. Its scratch
    is (324 N, B), component-major. Counted under
    ``launch_counts["qct_mpc_serial"]``."""
    N, B, device, F, diag, wout, ptrs = _mpc_args(block, yaw, phys, warm,
                                                  params, n_steps)
    lib = load()
    scratch = torch.empty((MPC_WORDS_PER_STEP * N, B), dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_mpc_serial(
            block.data_ptr(), *ptrs, F.data_ptr(), diag.data_ptr(),
            None if wout is None else wout.data_ptr(), scratch.data_ptr(),
            B, ctypes.byref(params), stream)
    _check(lib, rc, "qct_mpc_serial")
    launch_counts["qct_mpc_serial"] += 1
    return F, diag, wout


@functools.cache
def mpc_layout() -> MpcLayout:
    """The built MPC kernel's :class:`MpcLayout`."""
    lib = load()
    out = (ctypes.c_int * 3)()
    _check(lib, lib.qct_mpc_layout(out), "qct_mpc_layout")
    return MpcLayout(*out)


def _occupancy(fn, threads, shared_bytes):
    """[resident blocks per SM, registers per thread, local (stack) bytes
    per thread] of the kernel ``fn`` (a ``qct_*_fn`` entry of the library)
    at this block (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = load()
    out = (ctypes.c_int * 3)()
    _check(lib, lib.qct_occupancy(getattr(lib, fn)(), threads, shared_bytes,
                                  out), "qct_occupancy")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2])


def mpc_occupancy(B):
    """What the card makes of the MPC kernel's launch for B robots: dict of
    the build's layout, the geometry, the resident blocks per SM and the
    registers and local (stack) bytes per thread."""
    layout = mpc_layout()
    geo = mpc_launch_geometry(B, layout)
    return dict(layout._asdict(), **geo._asdict(),
                **_occupancy("qct_mpc_fn", geo.threads, geo.shared_bytes))


@functools.cache
def fused_layout() -> FusedLayout:
    """The built fused kernel's :class:`FusedLayout`."""
    lib = load()
    out = (ctypes.c_int * 3)()
    _check(lib, lib.qct_fused_layout(out), "qct_fused_layout")
    return FusedLayout(*out)


def fused_occupancy(B, polish=True):
    """What the card makes of the fused kernel's launch for B QPs (the
    polish variant, or the barrier-only one): dict of the build's layout,
    the geometry, the resident blocks per SM and the registers and local
    (stack) bytes per thread."""
    layout = fused_layout()
    geo = fused_launch_geometry(B, layout)
    fn = "qct_fused_polish_fn" if polish else "qct_fused_barrier_fn"
    return dict(layout._asdict(), **geo._asdict(),
                **_occupancy(fn, geo.threads, geo.shared_bytes))


@functools.cache
def dense_barrier_layout() -> FusedLayout:
    """The built dense barrier kernel's (K3a) :class:`FusedLayout`."""
    lib = load()
    out = (ctypes.c_int * 3)()
    _check(lib, lib.qct_dense_barrier_layout(out),
           "qct_dense_barrier_layout")
    return FusedLayout(*out)


def dense_barrier_occupancy(B):
    """What the card makes of the dense barrier kernel's (K3a) launch for B
    QPs: dict of the build's layout, the geometry, the resident blocks per
    SM and the registers and local (stack) bytes per thread."""
    layout = dense_barrier_layout()
    geo = fused_launch_geometry(B, layout)
    return dict(layout._asdict(), **geo._asdict(),
                **_occupancy("qct_dense_barrier_fn", geo.threads,
                             geo.shared_bytes))


@functools.cache
def dense_polish_layout() -> FusedLayout:
    """The built dense polish kernel's (K3b) :class:`FusedLayout`."""
    lib = load()
    out = (ctypes.c_int * 3)()
    _check(lib, lib.qct_dense_polish_layout(out), "qct_dense_polish_layout")
    return FusedLayout(*out)


def dense_occupancy(B):
    """What the card makes of the dense polish kernel's (K3b) launch for B
    QPs: dict of the build's layout, the geometry, the resident blocks per
    SM and the registers and local (stack) bytes per thread."""
    layout = dense_polish_layout()
    geo = dense_launch_geometry(B, layout)
    return dict(layout._asdict(), **geo._asdict(),
                **_occupancy("qct_dense_polish_fn", geo.threads,
                             geo.shared_bytes))


@functools.cache
def substep_layout() -> MpcLayout:
    """The built substep kernel's (K5) :class:`MpcLayout`."""
    lib = load()
    out = (ctypes.c_int * 3)()
    _check(lib, lib.qct_substep_layout(out), "qct_substep_layout")
    return MpcLayout(*out)


def substep_occupancy(B):
    """What the card makes of the substep kernel's (K5) launch for B robots:
    dict of the build's layout, the geometry, the resident blocks per SM and
    the registers and local (stack) bytes per thread."""
    layout = substep_layout()
    geo = substep_launch_geometry(B, layout)
    return dict(layout._asdict(), **geo._asdict(),
                **_occupancy("qct_substep_fn", geo.threads,
                             geo.shared_bytes))


class CommanderLayout(NamedTuple):
    """What a build of the commander-pre kernel (K4) reports
    (csrc/qct_commander.cuh ``qc_layout``): lanes per instance (neighbouring
    threads), threads a block."""

    lanes: int
    threads: int


@functools.cache
def commander_layout() -> CommanderLayout:
    """The built commander-pre kernel's (K4) :class:`CommanderLayout`."""
    lib = load()
    out = (ctypes.c_int * 2)()
    _check(lib, lib.qct_commander_layout(out), "qct_commander_layout")
    return CommanderLayout(*out)


def commander_geometry(B: int, layout: CommanderLayout | None = None
                       ) -> MpcGeometry:
    """K4's launch for B instances on ``layout`` (default: the build's,
    :func:`commander_layout`): blocks of ``layout.threads`` threads,
    ``layout.lanes`` an instance, no shared memory (instance slots past B
    write nothing)."""
    layout = commander_layout() if layout is None else layout
    per_block = layout.threads // layout.lanes
    if per_block < 1 or layout.threads % 32 != 0:
        raise ValueError(f"a block of {layout.threads} threads at "
                         f"{layout.lanes} lanes an instance is not whole "
                         f"warps of whole instances")
    return MpcGeometry(-(-B // per_block), layout.threads, per_block, 0)


def commander_occupancy(B):
    """What the card makes of K4's launch for B instances: dict of the
    build's layout, the geometry, the resident blocks per SM and the
    registers and local (stack) bytes per thread; under ``serial`` the same
    for the serial body's launch (one instance per thread)."""
    layout = commander_layout()
    geo = commander_geometry(B, layout)
    threads = load().qct_commander_serial_block(B)
    serial = dict(threads=threads, blocks=-(-B // threads),
                  **_occupancy("qct_commander_serial_fn", threads, 0))
    return dict(layout._asdict(), **geo._asdict(),
                **_occupancy("qct_commander_fn", geo.threads, 0),
                serial=serial)


def _dense_problem(Qp, cp, Gp, hp):
    device = cp.device
    B = cp.shape[1]
    for name, a, k in (("Q", Qp, 144), ("c", cp, 12), ("G", Gp, 288),
                       ("h", hp, 24)):
        _require_cuda(name, a, k, B, device)
    return device, B


def dense_barrier(Qp, cp, Gp, hp, *, iterations, tau):
    """Launch the dense barrier kernel (K3a) once on the equilibrated ``(k,
    B)`` CUDA tensors Q (144, B), c (12, B), G (288, B), h (24, B). Returns
    the best iterate (x (12, B), s (24, B), z (24, B)). The launch takes
    :func:`fused_launch_geometry` on :func:`dense_barrier_layout` (a group
    of lanes per QP, its problem, iterate and 12 x 12 factor in shared
    memory)."""
    device, B = _dense_problem(Qp, cp, Gp, hp)
    lib = load()
    x = torch.empty((12, B), dtype=torch.float32, device=device)
    s = torch.empty((24, B), dtype=torch.float32, device=device)
    z = torch.empty((24, B), dtype=torch.float32, device=device)
    geo = fused_launch_geometry(B, dense_barrier_layout())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_dense_barrier(
            Qp.data_ptr(), cp.data_ptr(), Gp.data_ptr(), hp.data_ptr(),
            x.data_ptr(), s.data_ptr(), z.data_ptr(), B, int(iterations),
            float(tau), geo.blocks, geo.threads, geo.shared_bytes, stream)
    _check(lib, rc, "qct_dense_barrier")
    launch_counts["qct_dense_barrier"] += 1
    return x, s, z


def dense_polish(Qp, cp, Gp, hp, x_in, s_in, z_in):
    """Launch the dense certified polish kernel (K3b) once on the problem of
    :func:`dense_barrier` from the point (x (12, B), s (24, B), z (24, B)).
    Returns (x, s, z, cert (B,)). The launch takes
    :func:`dense_launch_geometry` (a group of lanes per QP, its state and
    36 x 36 KKT factor in shared memory)."""
    device, B = _dense_problem(Qp, cp, Gp, hp)
    for name, a, k in (("x", x_in, 12), ("s", s_in, 24), ("z", z_in, 24)):
        _require_cuda(name, a, k, B, device)
    lib = load()
    x = torch.empty((12, B), dtype=torch.float32, device=device)
    s = torch.empty((24, B), dtype=torch.float32, device=device)
    z = torch.empty((24, B), dtype=torch.float32, device=device)
    cert = torch.empty((B,), dtype=torch.float32, device=device)
    geo = dense_launch_geometry(B, dense_polish_layout())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qct_dense_polish(
            Qp.data_ptr(), cp.data_ptr(), Gp.data_ptr(), hp.data_ptr(),
            x_in.data_ptr(), s_in.data_ptr(), z_in.data_ptr(), x.data_ptr(),
            s.data_ptr(), z.data_ptr(), cert.data_ptr(), B, geo.blocks,
            geo.threads, geo.shared_bytes, stream)
    _check(lib, rc, "qct_dense_polish")
    launch_counts["qct_dense_polish"] += 1
    return x, s, z, cert
