"""Launchers of the port: `serve` (continuous-batching LLM serving),
`train` (the end-to-end training driver), and the dry-run stack: `dryrun`
(every cell's step traced on the meta device), `roofline` (its terms on
the H100), `mesh` (logical meshes) and `report` (the tables)."""
