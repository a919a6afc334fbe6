"""Physics ops: plain torch glue and the kernel wrappers (``cuda/``)."""
