"""Scenario-axis parallelism (counterpart of
``quadruped_control_tpu/parallel``): the device mesh and its shardings
(``mesh``) and the multi-process bring-up (``distributed``)."""
