"""Device operations: projections, the Laplacian penalty and the fused sweep kernel."""
