"""Receding-horizon SRB MPC (counterpart of ``quadruped_control_tpu/mpc``):
the condensed horizon QP (``horizon``), the O(N) structured Riccati IPM
(``structured``) and the whole solve as one CUDA kernel (``fused_riccati``,
kernel K6)."""
