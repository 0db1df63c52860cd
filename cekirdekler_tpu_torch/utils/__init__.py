"""Utilities of the port: JSON sanitizing for exports (:mod:`.jsonsafe`)
and the seeded fault plane (:mod:`.faultinject`), copies of the
reference's modules of the same names."""
