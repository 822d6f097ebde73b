"""Command-line entry points and planning of the port: ``serve`` (the
LBCD-controlled analytics service), ``train`` (the training launcher,
one card or ``torchrun``), ``mesh`` (meshes of ranks over
``torch.distributed``), ``specs`` (``plan_cell``: a step over each
rank's slices) and ``roofline`` (model FLOPs and the per-device
accounting)."""
