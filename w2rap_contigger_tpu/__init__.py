"""w2rap_contigger_tpu — a JAX/XLA Illumina PE contig assembler.

A from-scratch reimplementation of the capabilities of
bioinfologics/w2rap-contigger (DISCOVAR-lineage C++/OpenMP assembler)
designed for data-parallel accelerators:

* reads live in dense 2-bit-packed tensors (core.reads),
* the k=60 de Bruijn dictionary is built by a sorted-kmer engine
  (ops.kmer_engine: kmerize -> canonicalize -> multiword sort -> segment
  reduce), replacing the reference's spinlocked hopscotch hash dictionary
  (reference: src/feudal/HashSet.h, src/kmers/ReadPather.h),
* unitig construction is an oriented successor function + pointer doubling
  (graph.build), replacing the sequential EdgeBuilder walk
  (reference: src/paths/long/BuildReadQGraph.cc:99-205),
* read pathing is a dense batched dictionary lookup + run-length decode
  (paths.pather), equivalent to the reference's seed-and-extend BRQ_Pather
  (reference: src/paths/long/BuildReadQGraph.cc:494-560),
* multi-chip scaling shards the kmer space by hash range over a
  jax.sharding.Mesh (parallel.mesh) instead of OpenMP threads.

The 7-step pipeline, checkpoint format and CLI semantics mirror
src/modules/w2rap-contigger.cc.
"""

__version__ = "0.1.0"

SMALL_K = 60  # the hard-coded small k (reference: src/modules/w2rap-contigger.cc:132)
