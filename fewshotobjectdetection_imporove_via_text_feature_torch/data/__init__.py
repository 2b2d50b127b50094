from .mapper import pick_bucket, resize_shortest_edge_size

__all__ = ["pick_bucket", "resize_shortest_edge_size"]
