"""Command-line entry points and planning of the port: ``serve`` (the
LBCD-controlled analytics service), ``train`` (the training launcher,
one card or ``torchrun``), ``mesh`` (meshes of ranks over
``torch.distributed``), ``specs`` (``plan_cell``: a step over each
rank's slices), ``dryrun`` (one rank's step of every cell counted on
fake tensors over a fake process group: FLOPs, bytes, memory and
collectives per device) and ``roofline`` (model FLOPs and the roofline
terms of the dry run's records)."""
