"""K5, ``poly::solve_lsa(costs (N, G, P) f32, valid (N, G) bool) -> (N, G)
i32``: the costs read once, the assignment written once.  The operations
depend on the data (the Dijkstra paths); counted here is what any exact
solver needs of these inputs, one comparison a cost, so the bound is a
least time and the share a lower one."""
from benchmark.roofline import numel

DEVICE_NAMES = ("lsa_kernel",)


def cost(shapes, dtypes, scalars):
    n, g, p = shapes[0]
    return 4 * n * g * p + n * g + 4 * n * g, float(numel(shapes[0])), "float32"
