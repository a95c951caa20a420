"""Command-line tools of the port, run as ``python -m
flake16_framework_tpu_torch.tools.<name>``: ``multihost_dryrun``, the
config batch across processes against one process."""
