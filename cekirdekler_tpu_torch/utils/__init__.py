"""Utilities of the port: JSON sanitizing for exports (:mod:`.jsonsafe`),
the seeded fault plane (:mod:`.faultinject`), copies of the reference's
modules of the same names, and device-timeline capture over
``torch.profiler`` (:mod:`.timeline`, the reference's on ``jax.profiler``)."""
