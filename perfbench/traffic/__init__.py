"""Seeded generators of the cells' inputs."""
