"""Hand-written CUDA kernels of the port (sources in ../csrc), each with its
plain torch version: K1 hash_slot, K2 csr_build, K3 probe_expand, K4
compact_gather (the INNER join); K5 filter_compact, K6 radix_sort, K7
segment_agg, K8 direct_agg (filter, sort and aggregate); K9 pair_fetch,
K10 match_flags, K11 concat_rows (the other join types); K12 pack_rows,
K13 append_rows (packing, out of core); K14 sorted_probe, K15 oa_place,
K16 oa_probe (the SORT and OA strategies); K17 expr_eval (expressions);
K18 dest_pack, K19 key_histogram (the distributed join's shuffle)."""
