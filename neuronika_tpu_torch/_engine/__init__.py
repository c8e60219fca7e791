"""The define-by-run engine: graph nodes and the tape executor."""
