"""Communication of the port. For now only the blockwise int8 quantizers
(``collectives.py``) that the int8 paged KV pool stores with; the
collectives themselves are ROADMAP A.7."""
