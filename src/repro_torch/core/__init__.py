"""Core of the port: AoPI, profiles, allocators, Algorithms 1-3."""
