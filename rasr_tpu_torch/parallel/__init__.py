"""Scale-out over ``torch.distributed``: the mesh and its collectives
(``mesh.py``), sharded compute (``sharded.py``), sequence parallelism
(``sequence.py``), the corpus work queue (``workqueue.py``) and the
multi-rank dry run (``dryrun.py``)."""
