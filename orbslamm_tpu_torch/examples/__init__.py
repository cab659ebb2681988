"""The port's example command lines (the reference's Examples/ drivers)."""
