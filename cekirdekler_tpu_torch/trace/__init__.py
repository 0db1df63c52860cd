"""Measurement helpers of the port: so far the overlap ceiling
(:mod:`.ceiling`); the reference's span tracer and device timelines are
ROADMAP Queue A 5."""
