"""Placements that split one transform, or a batch of them, over many
plan calls or ranks: the out-of-core four-step (`outofcore`), the
segmented batch split (`segmented`) and the cross-rank four-step
(`distributed`)."""
