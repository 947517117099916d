r"""Count annotated variant effects inside/outside called ROH (companion
tool).

Reproduces src/count_features_in_roh.pl (reference, 412 LoC): takes a
feature file (`chr:pos ref alt effect`), a GARLIC .roh.bed, a per-chromosome
VCF or TPED file pattern (must contain `chr<num>`), the max chromosome
number, and an output path.  For every homozygous carrier of a functional
allele it classifies the site against the individual's ROH intervals and
tallies per (individual, size class, effect).

Quirks preserved:

* chromosomes iterate from 22 (the hardcoded `$startchr = 22`, line 7) up
  to <num chr> inclusive;
* the BED interval end is stored as end-1 (half-open -> inclusive,
  line 108);
* VCF: the functional allele must be REF (code 0) or ALT (code 1); sites
  where neither matches warn and skip;
* homozygous test compares the FIRST allele to the functional allele and
  requires a1 == a2; missing first allele skips the sample;
* output columns: effects sorted, classes A B C NONE.

Deliberate divergence: the perl splits VCF genotypes on "/" only and keeps
FORMAT subfields glued to the second allele (`split(/\//, "1/1:30")` ->
("1", "1:30")), so homozygotes in VCFs with FORMAT data are never counted
and phased "|" separators crash with warnings.  Here the GT subfield is
extracted first and both separators are handled — the documented intent
rather than the bug.

Copy of garlic_tpu/tools/count_features_in_roh.py: the port imports
nothing of garlic_tpu.  Host only, as the source: no torch, no device.
Run as ``python -m garlic_tpu_torch.tools.count_features_in_roh``.
"""

from __future__ import annotations

import gzip
import re
import sys
from bisect import bisect_right
from collections import defaultdict


def _open(path: str):
    """Copy of garlic_tpu/tools/count_features_in_roh.py:40."""
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def hits_interval(intervals, query: int) -> str:
    """Binary search over sorted, disjoint (start, end, class) triples;
    returns the class letter or '0' (the reference's hitsInterval).

    Copy of garlic_tpu/tools/count_features_in_roh.py:44."""
    if not intervals:
        return "0"
    starts = [iv[0] for iv in intervals]
    i = bisect_right(starts, query) - 1
    if i >= 0 and intervals[i][0] <= query <= intervals[i][1]:
        return intervals[i][2]
    return "0"


def read_features(path: str):
    """chr -> pos -> functional allele -> effect, and the sorted effect
    types, from a `chr:pos ref alt effect` file.

    Copy of garlic_tpu/tools/count_features_in_roh.py:56."""
    effect = defaultdict(dict)       # chr -> pos -> allele -> effect
    effect_types = set()
    with _open(path) as fin:
        for line in fin:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            chrpos, ref, alt, eff = re.split(r"\s+", line)[:4]
            chrom, pos = chrpos.split(":")
            effect[chrom].setdefault(int(pos), {})[alt] = eff
            effect_types.add(eff)
    return effect, sorted(effect_types)


def read_roh(path: str):
    """ind -> chr -> [(start, end-1, class)] from a GARLIC .roh.bed.

    Copy of garlic_tpu/tools/count_features_in_roh.py:71."""
    roh = defaultdict(lambda: defaultdict(list))
    track = re.compile(r"^track .+Ind: (.+) Pop:(.+) ROH.+")
    ind = None
    with _open(path) as fin:
        for line in fin:
            line = line.rstrip("\n")
            m = track.match(line)
            if m:
                ind = m.group(1)
                continue
            if not line.strip():
                continue
            fields = re.split(r"\s+", line, maxsplit=5)
            chrom, start, end, cls = fields[0], int(fields[1]), \
                int(fields[2]), fields[3]
            roh[ind][chrom].append((start, end - 1, cls))
    return roh


def _chr_files(genfile: str, numchr: int, startchr: int = 22):
    """The per-chromosome file names, chr<startchr> .. chr<numchr>, from
    the pattern around `chr<num>` in genfile.

    Copy of garlic_tpu/tools/count_features_in_roh.py:92."""
    m = re.match(r"(.+)?chr\d+(.+)?", genfile)
    if not m:
        print(r"ERROR: Could not match pattern m/(.+)?chr\d+(.+)?/ to "
              f"{genfile} to generate file list.", file=sys.stderr)
        print("\tPlease name your files *chr{num}*, i.e. data.chr1.tped, "
              "data.chr2.tped, etc.", file=sys.stderr)
        raise SystemExit(1)
    front = m.group(1) or ""
    back = m.group(2) or ""
    return [f"{front}chr{i}{back}".strip()
            for i in range(startchr, numchr + 1)]


def run(featurefile: str, rohfile: str, genfile: str, numchr: int,
        outfile: str, startchr: int = 22) -> None:
    """Tallies, per individual, size class and effect, the homozygous
    carriers of functional alleles, and writes the table to outfile.

    Copy of garlic_tpu/tools/count_features_in_roh.py:106."""
    if re.match(r".*\.vcf(\.gz)?$", genfile):
        filetype = "VCF"
    elif re.match(r".*\.tped(\.gz)?$", genfile):
        filetype = "TPED"
    else:
        print(f"ERROR: {genfile} not recognzied as vcf or tped (based on "
              "file name extension).", file=sys.stderr)
        raise SystemExit(1)

    genfilelist = _chr_files(genfile, numchr, startchr)
    effect, effect_list = read_features(featurefile)
    print(f"Reading {rohfile}...", file=sys.stderr)
    roh = read_roh(rohfile)

    # individual list
    indlist = []
    if filetype == "VCF":
        print("Loading individual list.", file=sys.stderr)
        with _open(genfilelist[0]) as fin:
            for line in fin:
                line = line.rstrip("\n")
                if line.startswith("##"):
                    continue
                if line.startswith("#CHROM"):
                    indlist = re.split(r"\s+", line)[9:]
                else:
                    break
    else:
        tfam = re.sub(r"\.tped", ".tfam", genfilelist[0])
        with _open(tfam) as fin:
            for line in fin:
                fields = re.split(r"\s+", line.strip(), maxsplit=2)
                if len(fields) >= 2:
                    indlist.append(fields[1])

    counts = {ind: {c: {f: 0 for f in effect_list}
                    for c in ("A", "B", "C", "NONE")} for ind in indlist}

    for chrom_i, path in zip(range(startchr, numchr + 1), genfilelist):
        chrstr = f"chr{chrom_i}"
        print(chrstr, file=sys.stderr)
        eff_chr = effect.get(chrstr, {})
        with _open(path) as fin:
            for line in fin:
                line = line.rstrip("\n")
                if filetype == "VCF":
                    if line.startswith("#"):
                        continue
                    fields = re.split(r"\s+", line)
                    pos = int(fields[1])
                    ref, alt = fields[3], fields[4]
                    genos = fields[9:]
                    if pos not in eff_chr:
                        continue
                    if ref in eff_chr[pos]:
                        fa, fa_atcg = "0", ref
                    elif alt in eff_chr[pos]:
                        fa, fa_atcg = "1", alt
                    else:
                        print(f"Neither {ref} nor {alt} are in the feature "
                              f"file, but {chrstr}:{pos} is.",
                              file=sys.stderr)
                        continue
                    for i, ind in enumerate(indlist):
                        gt = genos[i].split(":")[0]
                        hap = re.split(r"[/|]", gt)
                        if len(hap) < 2 or hap[0] == ".":
                            continue
                        if hap[0] == fa and hap[0] == hap[1]:
                            cls = hits_interval(roh[ind].get(chrstr, []),
                                                pos)
                            e = eff_chr[pos][fa_atcg]
                            counts[ind]["NONE" if cls == "0" else cls][e] += 1
                else:
                    fields = re.split(r"\s+", line)
                    pos = int(fields[3])
                    genos = fields[4:]
                    if pos not in eff_chr:
                        continue
                    for i, ind in enumerate(indlist):
                        a1, a2 = genos[2 * i], genos[2 * i + 1]
                        if a1 == "0":
                            continue
                        if a1 in eff_chr[pos] and a1 == a2:
                            cls = hits_interval(roh[ind].get(chrstr, []),
                                                pos)
                            e = eff_chr[pos][a1]
                            counts[ind]["NONE" if cls == "0" else cls][e] += 1

    classes = ("A", "B", "C", "NONE")
    with open(outfile, "w") as fout:
        fout.write(" ".join(f"{f}{c}" for f in effect_list
                            for c in classes) + " \n")
        for ind in indlist:
            row = [ind]
            for f in effect_list:
                for c in classes:
                    row.append(str(counts[ind][c][f]))
            fout.write(" ".join(row) + "\n")


def main(argv=None) -> int:
    """The command line: five arguments, else the usage lines and exit 1.

    Copy of garlic_tpu/tools/count_features_in_roh.py:209."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 5:
        print("./count_features_in_roh.pl <feature file> <roh file> "
              "<tped/vcf file> <num chr> <out file>", file=sys.stderr)
        print("If a TPED file is given, a TFAM file is also expected with "
              "the same basename.", file=sys.stderr)
        return 1
    run(argv[0], argv[1], argv[2], int(argv[3]), argv[4])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
