"""Host-side chunk sizing shared by ingestion (api.py) and post-hoc
statistics (assign.py): row blocks of ~16M elements (128 MB at float64)
bound every full-matrix pass without a full-size temporary."""

HOST_CHUNK_ELEMENTS = 1 << 24


def host_row_chunk(G: int) -> int:
    return max(1, HOST_CHUNK_ELEMENTS // max(G, 1))
