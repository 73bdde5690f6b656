"""Example programs of the port, run as `python -m dlrm_flexflow_tpu_torch.examples.<name>`."""
