"""Pipelines: the denoise loop and text-to-video generation."""
