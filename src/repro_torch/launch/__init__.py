"""Launch-side analysis for the port: the reference's production meshes
as port meshes (``launch.mesh``), the step builders of every (arch ×
shape) cell (``launch.steps``), the dry run on meta tensors
(``launch.dryrun``) and the roofline of stencil steps and dry-run cells
(``launch.roofline``)."""
