"""Rigid-body physics: broadphase -> narrowphase -> contact solve ->
integration -> sleeping, as plain tensor functions (see step.py)."""
