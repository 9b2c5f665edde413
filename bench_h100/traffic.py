"""The general generator of the benchmark's traffic. A traffic mix is a data
file under workloads/ (its ``traffic`` object); everything here draws from
one ``torch.Generator`` seeded by ``--seed``, on the device it is given, so
the same seed gives the same inputs.

GRF scenarios follow the reference benchmark's operating envelope (configs
1-3 of the reference package's scenario suite: static stance, body-pose
tracking sweeps, trot contact schedules): base tilt uniform in +-rpy, height
uniform in z_range, Gaussian velocities, feet scattered about the standing
pose, one stance pattern per scenario."""

import torch

SCENARIO_KEYS = ("R", "R_d", "x", "xdot", "w", "x_d", "xdot_d", "w_d",
                 "feet", "stance")


def rpy_to_matrix(rpy):
    """R = Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp = torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row = torch.stack
    return row([
        row([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        row([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        row([-sp, cp * sr, cp * cr], -1)], -2)


def standing_feet(kin: dict, q0, dtype, device):
    """Feet in the body frame at joint angles q0 (the same for every leg),
    legs [RL, FL, RR, FR]."""
    x, y, z = kin["hip_x"], kin["hip_y"], kin["hip_z"]
    hips = torch.tensor([[-x, y, z], [x, y, z], [-x, -y, z], [x, -y, z]],
                        dtype=dtype, device=device)
    l1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dtype,
                      device=device) * kin["l1"]
    q = torch.tensor(q0, dtype=dtype, device=device)
    s1, c1 = torch.sin(q[0]), torch.cos(q[0])
    s2, c2 = torch.sin(q[1]), torch.cos(q[1])
    s23, c23 = torch.sin(q[1] + q[2]), torch.cos(q[1] + q[2])
    l2, l3 = -kin["l2"], -kin["l3"]     # the reference's link_map_ signs
    fx = l2 * s2 + l3 * s23 + hips[:, 0]
    fy = l1 * c1 - l2 * s1 * c2 - l3 * s1 * c23 + hips[:, 1]
    fz = l1 * s1 + l2 * c1 * c2 + l3 * c1 * c23 + hips[:, 2]
    return torch.stack([fx, fy, fz], -1)


def grf_scenarios(t: dict, cfg: dict, batch: int, gen: torch.Generator,
                  device) -> dict:
    """One batch of GRF scenarios (float32) from the traffic parameters
    ``t`` and the configuration ``cfg``."""
    kw = dict(dtype=torch.float32, device=device, generator=gen)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, **kw)

    def normal(shape):
        return torch.randn(shape, **kw)

    feet0 = standing_feet(cfg["kinematics"], cfg["standing_q"],
                          torch.float32, device)
    a = t["rpy_halfwidth"]
    R = rpy_to_matrix(uniform((batch, 3), -a, a))
    x = torch.zeros((batch, 3), dtype=torch.float32, device=device)
    x[:, 2] = uniform((batch,), *t["z_range"])
    xdot = t["xdot_sigma"] * normal((batch, 3))
    w = t["w_sigma"] * normal((batch, 3))
    xdot_d = t["xdot_d_sigma"] * normal((batch, 3))
    w_d = t["w_d_sigma"] * normal((batch, 3))
    x_d = torch.zeros((batch, 3), dtype=torch.float32, device=device)
    x_d[:, 2] = cfg["stand_height"]
    feet = feet0 + t["feet_sigma"] * normal((batch, 4, 3))
    patterns = torch.tensor(t["stance_patterns"], dtype=torch.bool,
                            device=device)
    pick = torch.randint(0, len(t["stance_patterns"]), (batch,),
                         device=device, generator=gen)
    eye = torch.eye(3, dtype=torch.float32, device=device).expand(
        batch, 3, 3).contiguous()
    return dict(R=R, R_d=eye, x=x, xdot=xdot, w=w, x_d=x_d, xdot_d=xdot_d,
                w_d=w_d, feet=feet, stance=patterns[pick])
