"""Placements that stream or split one transform over many plan calls: the
out-of-core four-step (`outofcore`)."""
