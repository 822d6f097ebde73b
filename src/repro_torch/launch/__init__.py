"""Command-line entry points of the port: ``serve`` (the LBCD-controlled
analytics service), ``train`` (the training launcher) and ``roofline``'s
analytic half (active parameters, model FLOPs)."""
