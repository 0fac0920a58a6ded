"""Rank decomposition (mesh) and halo exchange (halo), as the solvers
import them; the reference runs on one rank."""
