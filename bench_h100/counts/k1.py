"""K1, the fused GRF-QP kernel (``qct_fused_barrier_kernel`` and
``qct_fused_polish_kernel``): float32 operations and bytes from the schedule
and the batch alone, never from a count the kernel reports.

Operations are one per add, subtract, multiply, divide, square root and
compare/select of the loops in csrc/qct_common.cuh (the arithmetic of
chip_smoke.py's ``ops_barrier_iteration``, ``ops_polish_sweep`` and
``ops_fused``, frozen here). A launch is counted with every barrier
iteration its schedule fixes on every instance, and ONE polish sweep per
instance per polish call: the least the schedule runs (a lane leaves the
sweep loop once certified, so the sweeps run depend on the data). Bytes:
each input word read once, each output word written once."""

_GX = 16 * 3 + 8 * 1             # (G x) over the 24 sparse rows
_GTY = 8 * 3 + 4 * 11            # (G^T z) over the 12 sparse columns
_CHOL_SOLVE = 2 * (2 * 66 + 12)  # forward + backward 12x12 triangular solves
_KKT_FLAGS = 24 * 6 + _GX + 12 * 25 + _GTY + 80
_ASSEMBLE = 10 * 9 * 4 + 78 * 2 + 4 * 30 + 24
_EQUIL = 12 * 3 + 78 * 3 + 24 * 8 + 12 * 3

IN_WORDS = 26      # r (12), b (6), stance (4), mu, fz_min, fz_max, pad
OUT_WORDS = 66     # x (12), s (24), z (24), diag (6)
WARM_WORDS = 60    # x, s, z of a warm start


def barrier_iteration() -> int:
    newton = (24 * 3 + 12 * 2 + _GTY + 2 * _CHOL_SOLVE + 12 * 25 + 12
              + _GX + 24 * 2 + 24 * 4)
    chol = sum(2 * j + 3 + (11 - j) * (2 * j + 1) for j in range(12))
    return (_GX + 48 + 12 * 24 + _GTY + 12      # residuals
            + 48 + 16 * 8 + 8 * 3 + 24          # d, G^T D G, shift
            + chol + 48                          # Cholesky, mu
            + 2 * newton + 4 * (24 * 4 + 2)      # two directions, step rules
            + 24 * 5 + 6 + 24 * 4                # mu_aff, sigma, corrector rc
            + 72 + 5 + 72 + 60 * 3)              # merit, guards, update


def polish_sweep(refine: int, ff: bool) -> int:
    ldl = sum(3 * j + 2 + (35 - j) * (3 * j + 1) for j in range(36))
    solve = 4 * 630 + 36
    plain_res = 12 * 24 + 40 * 3 + 24 * 8
    ff_term = 25                                  # two_prod 17, two_sum 6, 2
    ff_dual = 4 * 49 * ff_term + 4 * 49
    ff_primal = (24 * 2 + 40) * ff_term + 24 * 6
    passes = 0
    for k in range(refine):
        if not ff or (k == 0 and refine > 1):
            passes += plain_res
        else:
            passes += ff_dual + ff_primal
    return (100 + ldl + (1 + refine) * solve + passes + 36 * refine
            + ff_dual + _GX + 24 + 72 + 36 + 24 * 6)


def launch(batch: int, *, iterations: int, polish: bool, warm: bool,
           polish_refine: int = 4, ff_refine: bool = True,
           prox_steps: int = 0, prox_iterations: int = 0,
           warm_words: int = WARM_WORDS):
    """(operations, bytes) of one K1 launch over ``batch`` instances."""
    per_lane = _ASSEMBLE + _EQUIL + 2 * _KKT_FLAGS + 60 * 3
    per_lane += prox_steps * (_EQUIL + 60 * 8 + _KKT_FLAGS)
    per_lane += (iterations + prox_steps * prox_iterations) * \
        barrier_iteration()
    if polish:
        per_lane += polish_sweep(polish_refine, ff_refine)
        per_lane += prox_steps * polish_sweep(polish_refine, False)
    nbytes = 4 * batch * (IN_WORDS + OUT_WORDS + (warm_words if warm else 0))
    return batch * per_lane, nbytes


def _rows_tile(rows) -> int:
    return (8 if rows is None else int(rows)) * 128


def padded_batch(B: int, rows, multiple: int = 1) -> int:
    tile = _rows_tile(rows) * multiple
    return -(-int(B) // tile) * tile


def two_phase_tail_size(B: int, rows, tail_divisor: int) -> int:
    """The re-solved tail of the two-phase solve (the JAX package's size)."""
    return min(padded_batch(B, rows, tail_divisor) // tail_divisor, int(B))


def prox_slice_size(B: int, rows, two_phase: bool, tail_divisor: int,
                    prox_divisor: int) -> int:
    """The kernel-backend prox slice (the JAX package's size), capped at B."""
    r = 8 if rows is None else int(rows)
    Bp = padded_batch(B, r, tail_divisor if two_phase else 1)
    Bt = max(Bp // prox_divisor, 1)
    if Bp >= 1024:
        Bt = -(-max(Bt, 1024) // 1024) * 1024
    tile_k = min(r, 8) * 128
    return min(-(-Bt // tile_k) * tile_k, Bp, int(B))


def fused_solve(B: int, s: dict):
    """The launches of ``solve_balance_qp_fused`` under schedule ``s`` (the
    keyword arguments of the call) as (stage, batch, operations, bytes):
    split phase 1 (barrier-only, then polish-only), the two-phase tail, the
    kernel prox stage."""
    refine = s.get("polish_refine", 4)
    out = []

    def add(stage, batch, **kw):
        ops, nb = launch(batch, polish_refine=refine, **kw)
        out.append((stage, batch, ops, nb))

    if not (s.get("two_phase") and s.get("split")):
        raise ValueError("counted schedules are two_phase + split")
    add("barrier", B, iterations=s["iterations"], polish=False, warm=False)
    add("polish", B, iterations=0, polish=True, warm=True)
    Bt = two_phase_tail_size(B, s.get("rows"), s.get("tail_divisor", 8))
    add("tail", Bt, iterations=s["tail_iterations"], polish=True,
        warm=False, prox_steps=s.get("tail_prox_steps", 0),
        prox_iterations=s.get("tail_prox_iterations", 10))
    if s.get("prox_tail"):
        if s.get("prox_backend", "kernel") != "kernel":
            raise ValueError("counted prox stage is the kernel backend")
        Bp = prox_slice_size(B, s.get("rows"), True,
                             s.get("tail_divisor", 8),
                             s.get("prox_divisor", 64))
        add("prox", Bp, iterations=0, polish=True, warm=True,
            prox_steps=s["prox_steps"], prox_iterations=s["prox_iterations"])
    return out
