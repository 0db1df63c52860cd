"""Utilities of the port: JSON sanitizing for exports (:mod:`.jsonsafe`),
the seeded fault plane (:mod:`.faultinject`) and checkpoints
(:mod:`.checkpoint`, over torch state dicts in place of jax pytrees),
copies of the reference's modules of the same names, device-timeline
capture over ``torch.profiler`` (:mod:`.timeline`, the reference's on
``jax.profiler``), and queue markers (:mod:`.markers`) and user events
(:mod:`.events`), the reference's pure-Python paths on the port's
completion handles."""
