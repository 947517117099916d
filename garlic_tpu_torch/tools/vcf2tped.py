"""VCF -> TPED/TFAM converter (companion tool).

Reproduces src/vcf2tped.pl (reference): GT field only, output paths derived
by replacing the .vcf extension, TFAM rows `0\t<id>\t0\t0\t0\t0`, genetic
position written as 0.  Quirks preserved:

* only allele codes 0, 1 and '.' are handled — a multi-allelic code (2+)
  emits NOTHING for that haplotype (the perl regex alternation, lines
  44-63);
* rows whose genotype fields do not match ``[0-9.][/|][0-9.]`` are skipped
  silently for that sample;
* input may be gzipped (extension .vcf.gz -> .tped.gz/.tfam kept plain, an
  extension the perl tool rejects; plain .vcf matches the reference).

Copy of garlic_tpu/tools/vcf2tped.py: the port imports nothing of
garlic_tpu.  Host only, as the source: no torch, no device.  Run as
``python -m garlic_tpu_torch.tools.vcf2tped <vcf>``.
"""

from __future__ import annotations

import gzip
import re
import sys

# copy of garlic_tpu/tools/vcf2tped.py:22
_GT = re.compile(r"((\d|\.)(\/|\|)(\d|\.))(:.+)?")


def convert(vcffile: str, tpedfile: str, tfamfile: str) -> None:
    """VCF -> TPED + TFAM, GT field only.

    Copy of garlic_tpu/tools/vcf2tped.py:25."""
    opener = gzip.open if vcffile.endswith(".gz") else open
    with opener(vcffile, "rt") as fin, open(tpedfile, "w") as tped:
        for line in fin:
            line = line.rstrip("\n")
            if line.startswith("#CHROM"):
                fields = re.split(r"\s+", line)
                data = fields[9:]
                with open(tfamfile, "w") as tfam:
                    for ind in data:
                        tfam.write(f"0\t{ind}\t0\t0\t0\t0\n")
                continue
            if line.startswith("#"):
                continue
            fields = re.split(r"\s+", line)
            chrom, pos, rsid, ref, alt = fields[0:5]
            data = fields[9:]
            out = [f"{chrom}\t{rsid}\t0\t{pos}"]
            for dat in data:
                m = _GT.match(dat)
                if not m:
                    continue
                for hap in (m.group(2), m.group(4)):
                    if hap == "0":
                        out.append(f"\t{ref}")
                    elif hap == "1":
                        out.append(f"\t{alt}")
                    elif hap == ".":
                        out.append("\t0")
                    # 2+ alleles: nothing emitted (reference quirk)
            tped.write("".join(out) + "\n")


def main(argv=None) -> int:
    """The command line: the output paths from the input's extension;
    exit 1 with the perl tool's usage line, or on an unknown extension.

    Copy of garlic_tpu/tools/vcf2tped.py:58."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("./vcf2tped.pl <vcf file>", file=sys.stderr)
        return 1
    vcffile = argv[0]
    if vcffile.endswith(".vcf"):
        base = vcffile[: -len(".vcf")]
    elif vcffile.endswith(".vcf.gz"):
        base = vcffile[: -len(".vcf.gz")]
    else:
        print(f"{vcffile} not recognized as a vcf file based on file name "
              "extension.", file=sys.stderr)
        return 1
    convert(vcffile, base + ".tped", base + ".tfam")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
