"""The companion tools: vcf2tped (VCF -> TPED/TFAM) and
count_features_in_roh (annotated effects by ROH size class).

Counterpart of garlic_tpu/tools/; host only."""
