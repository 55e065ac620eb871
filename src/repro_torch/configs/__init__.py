"""Architecture and shape-cell configs (data; see `base`)."""
