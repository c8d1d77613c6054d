"""Code-vector retrieval on the card: the counterpart of
code2vec_tpu/retrieval/.

- `store.py`     the sharded vector store the `embed` command writes (a
                 copy of the reference's, byte-compatible both ways).
- `embed_job.py` the `embed` command: a `.c2v` corpus through a release
                 model's eval step into a store.
- `index.py`     the `index-build` command: k-means (K9, K10), inverted
                 lists, IVF search (K11) and brute force (K3's float32
                 mode), with the reference's index artifact.
- `mips.py`      the approximate-MIPS prediction head (K11 over the int8
                 target table).
- `api.py`       the /neighbors mount of `serve --retrieval_index`.

The reference's `obs` counters, gauges and histograms of these modules
are not ported: the port has no `obs` yet.
"""
