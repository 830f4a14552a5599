"""Hand-written CUDA kernels of the port (sources in ../csrc), each with its
plain torch version: K1 hash_slot, K2 csr_build, K3 probe_expand, K4
compact_gather (the INNER join); K5 filter_compact, K6 radix_sort, K7
segment_agg, K8 direct_agg (filter, sort and aggregate)."""
