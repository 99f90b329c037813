"""Roofline terms for the port's steps on an H100 (port of ``repro.roofline``):
``counts`` counts a step's FLOPs, bytes and memory on the meta device,
``analysis`` turns the counts into three terms, ``reanalyze`` recomputes
them over saved dry-run records."""
