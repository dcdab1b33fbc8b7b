"""VCF ingest: `vcf2graph.vcf_to_graph` builds the graph the pipeline reads
(`python -m phi_tpu_torch.vcfio.vcf2graph -v VCF -r REF.fa > out.gfa`)."""
