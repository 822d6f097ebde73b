"""Command-line entry points of the port. Only ``serve`` (the
LBCD-controlled analytics service) is ported."""
