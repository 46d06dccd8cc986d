"""Checkpoint bundles (training itself comes in a later slice)."""
