"""Driver of the solve cells: a closed loop with one batch in flight. The
user is a tuning or learning loop that waits for each batch's certified
forces; it submits a batch, waits for it (``torch.cuda.synchronize``) and
submits the next, cycling through a pool of scenario batches made at
set-up from the seed.

The timed call is solver/fused.solve_balance_qp_fused, K1's fused solve.
Workload keys: ``batch``, ``pool``, ``traffic`` (traffic.grf_scenarios'
parameters), ``schedule`` (the solve's keyword arguments),
``sample_per_batch`` (instances of each pool batch judged against the
reference) and ``limits``."""

import time

import torch

import traffic
from counts import k1
from reference import grf_qp, presets

K1_KERNELS = ("qct_fused_barrier_kernel", "qct_fused_polish_kernel")


def port_config(cfg: dict):
    """The port's preset for this configuration, held number for number
    against the configuration file (the file is what is run)."""
    from quadruped_control_tpu_torch.config import mit_cheetah_config

    pc = mit_cheetah_config()
    presets.check(pc, {"balance": cfg["balance"],
                       "kinematics": cfg["kinematics"],
                       "stand": {"height": cfg["stand_height"]}},
                  cfg["name"])
    return pc


class Driver:
    unit = "solve"

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.B = int(wl["batch"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.pool = [traffic.grf_scenarios(wl["traffic"], cfg, self.B, gen,
                                           device)
                     for _ in range(int(wl["pool"]))]
        self.pick = torch.Generator(device="cpu")
        self.pick.manual_seed(seed)
        self.pc = port_config(cfg)
        self.solve = self._entry()
        if device.type == "cuda":
            # Warm every shape of the window: the stage sizes are fixed by
            # the batch, so two calls on pool batches build and warm all.
            for i in range(2):
                self.solve(self.pool[i])
            torch.cuda.synchronize()

    def _entry(self):
        from quadruped_control_tpu_torch.solver.fused import (
            solve_balance_qp_fused)
        bal = self.pc.balance
        keys = traffic.SCENARIO_KEYS
        sched = dict(self.wl["schedule"])

        def solve(s):
            sol = solve_balance_qp_fused(*[s[k] for k in keys], bal, **sched)
            return sol.x, sol.converged
        return solve

    def window(self, seconds: float, tracer):
        """Run the closed loop for ``seconds``; return the raw tallies."""
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        P = len(self.pool)
        ok = torch.zeros((), dtype=torch.int64, device=self.device)
        lat, host, in_trace = [], [], []
        self.last = [None] * P
        i = 0
        sync()
        t_start = time.perf_counter()
        t_end = t_start
        while t_end - t_start < seconds:
            tracer.maybe_start(t_end - t_start, seconds)
            s = self.pool[i % P]
            t0 = time.perf_counter()
            x, conv = self.solve(s)
            t1 = time.perf_counter()
            ok += (conv & torch.isfinite(x).all(-1)).sum()
            sync()
            t_end = time.perf_counter()
            lat.append(t_end - t0)
            host.append(t1 - t0)
            in_trace.append(tracer.active)
            self.last[i % P] = (x, conv)
            i += 1
        tracer.stop()
        self.n = i
        self.ok = int(ok.item())
        untraced = [h for h, tr in zip(host, in_trace) if not tr] or host
        return dict(window_s=t_end - t_start, units=i,
                    traced_units=sum(in_trace), latencies=lat,
                    host_ms=1e3 * sum(untraced) / len(untraced),
                    attempted=i * self.B, failed=i * self.B - self.ok)

    def end_to_end(self, r):
        lat = sorted(r["latencies"])
        k = max(0, -(-95 * len(lat) // 100) - 1)   # nearest-rank 95th
        return {"certified_qps": (self.ok / r["window_s"], "QPs/s"),
                "solve_ms_p95": (1e3 * lat[k], "ms")}

    def bounds(self):
        """Least device seconds of one solve per kernel family, from the
        schedule and the batch alone (counts/)."""
        from peaks import bound_s

        launches = k1.fused_solve(self.B, self.wl["schedule"])
        return {"k1": (sum(bound_s(o, b) for _, _, o, b in launches),
                       K1_KERNELS)}

    def occupancy(self):
        """What the card makes of the window's launches (printed, not a
        metric)."""
        from quadruped_control_tpu_torch import kernels

        return {"k1_polish": kernels.fused_occupancy(self.B, True),
                "k1_barrier": kernels.fused_occupancy(self.B, False)}

    def expect_launches(self, launches, units):
        """The window went through K1's four launches a solve and no other
        kernel (on the card; the CPU runs the plain versions and launches
        nothing)."""
        if self.device.type != "cuda":
            return
        want = {"qct_fused_solve": 4 * units}
        if launches != want:
            raise SystemExit(f"launches {launches}, expected {want}")

    def free(self):
        """Drop everything of the program's but the judged answers."""
        self.solve = None

    def answers(self):
        """The judged sample: from each pool batch's last solve in the
        window, ``sample_per_batch`` instances drawn from the seed."""
        if getattr(self, "_answers", None) is not None:
            return self._answers
        n = int(self.wl["sample_per_batch"])
        out = []
        for j, got in enumerate(self.last):
            if got is None:
                continue
            idx = torch.randperm(self.B, generator=self.pick)[:n].to(
                self.device)
            s = {k: v[idx] for k, v in self.pool[j].items()}
            out.append((s, got[0][idx], got[1][idx]))
        self._answers = out
        return out

    def check(self, answers=None):
        """Numbers compared, each (name, value, limit): the share of the
        window's instances not certified or not finite, and against the
        float64 reference on the judged sample of certified instances, the
        widest and the median objective gap and the widest cone violation."""
        lim = self.wl["limits"]
        answers = self.answers() if answers is None else answers
        gaps, viols, refc = [], [], []
        for s, x, conv in answers:
            gap, viol, rc = grf_qp.judge(s, self.cfg["balance"], x)
            m = conv.bool()
            gaps.append(gap[m].abs())
            viols.append(viol[m])
            refc.append(rc)
        gap = torch.cat(gaps) if gaps else torch.zeros(0, dtype=torch.float64)
        viol = torch.cat(viols) if viols else gap
        nan = float("nan")
        self.judged = int(gap.numel())
        self.ref_converged = float(torch.cat(refc).float().mean()) \
            if refc else nan
        unc = 1.0 - self.ok / (self.n * self.B) if self.n else nan
        return [("uncertified", unc, lim["uncertified"]),
                ("gap_max", float(gap.max()) if gap.numel() else nan,
                 lim["gap_max"]),
                ("gap_median", float(gap.median()) if gap.numel() else nan,
                 lim["gap_median"]),
                ("viol_max_N", float(viol.max()) if viol.numel() else nan,
                 lim["viol_max_N"])]

    def control_answers(self):
        """The control in the program's place on the judged sample: the
        reference computed in TF32, answering every instance."""
        out = []
        for s, _x, _c in self.answers():
            x = grf_qp.control_answers(s, self.cfg["balance"])
            out.append((s, x, torch.ones_like(_c, dtype=torch.bool)))
        return out
