"""Launch-side analysis for the port.  Only the stencil half of the
reference's ``repro.launch.roofline`` is here (``launch.roofline``:
``RooflineTerms`` with the H100's terms, and the counts it reads from the
IR); the LM half (cells, reports, the dry run) is not ported yet."""
