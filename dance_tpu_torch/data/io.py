"""h5ad / h5mu files (counterpart: dance_tpu/data/io.py, which reads and
writes anndata's on-disk format through h5py).

h5py is not on the machine with the card, so every entry point here raises
``NotImplementedError`` naming it. Build an :class:`~.container.AnnData`
from arrays instead (ROADMAP Queue 3).
"""


def _no_h5py(name: str):
    raise NotImplementedError(f"{name} needs h5py, which the port does not use (the card's "
                              f"machine has no h5py); build the AnnData from arrays")


def read_h5ad(path):
    _no_h5py("read_h5ad")


def read_h5mu(path):
    _no_h5py("read_h5mu")


def write_h5ad(adata, path):
    _no_h5py("write_h5ad")


def write_h5mu(mdata, path):
    _no_h5py("write_h5mu")


__all__ = ["read_h5ad", "read_h5mu", "write_h5ad", "write_h5mu"]
