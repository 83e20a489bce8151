"""Drivers: ``run(cell, seed, seconds, trace, device)`` of one kind of job."""
