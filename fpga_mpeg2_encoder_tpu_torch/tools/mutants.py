"""Mutation check of a kernel source on a CUDA card.

    python3 fpga_mpeg2_encoder_tpu_torch/tools/mutants.py me.cu [--jobs 4]
    python3 fpga_mpeg2_encoder_tpu_torch/tools/mutants.py transform.cu
    python3 fpga_mpeg2_encoder_tpu_torch/tools/mutants.py acsym.cu
    python3 fpga_mpeg2_encoder_tpu_torch/tools/mutants.py pack.cu
    python3 fpga_mpeg2_encoder_tpu_torch/tools/mutants.py glue.cu
    python3 fpga_mpeg2_encoder_tpu_torch/tools/mutants.py subsample.cu
    python3 fpga_mpeg2_encoder_tpu_torch/tools/mutants.py carry.cu

Each mutant breaks one exactness trap (or one step of the design) of the
kernel source with a one-line change.  It runs in its own copy of the port
package and of tests/test_torch_cuda.py under the package's git-ignored
build/mutants/, which builds its own kernels, and there the card's tests of
that source (``pytest --noconftest -x -k <selection>``) must fail.  The
unchanged copy runs first and must pass.  Prints one line per mutant; exits
1 if the baseline fails or a mutant is missed.
"""
import argparse
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
WORK = os.path.join(PKG, "build", "mutants")

# source -> (the card tests' -k selection, [(name, text of the source, its
# mutant)]); each text occurs once in its source
MUTANTS = {
    "me.cu": ("me_", [
        ("overflow_mask", "const bool invalid = (s > 4095) |", "const bool invalid = (s > 8191) |"),
        ("fullpel_edge_left", "(edge_l & (dx < 0)) |", "false |"),
        ("fullpel_edge_top", "(edge_t & (dy < 0)) |", "false |"),
        ("edge_top_global", "const bool edge_t = first_mb_row + by == 0;",
         "const bool edge_t = by == 0;"),
        ("edge_bottom_global", "const bool edge_b = first_mb_row + by == total_mb_rows - 1;",
         "const bool edge_b = by == nby - 1;"),
        ("tie_break", "(255u - lin)", "lin"),
        ("all_invalid_centre", "kmin >= BIG ? YRC * 16 + YRC :", "kmin >= BIG ? 0 :"),
        ("range_end_dx", "(dx < -yr) | (dx > yr);", "(dx < -yr) | (dx > yr + 1);"),
        # the strip's window: the shifted copies, the row word after each
        # 16-byte word, the halo rows, a macroblock's own columns
        ("shifted_copy", "wv[j + 1], 8 * cp);", "wv[j + 1], 8 * (3 - cp));"),
        ("copy_next_word", "lv[it].w, ln[it]};", "lv[it].w, 0u};"),
        ("window_halo", "y0 - YRC - 1 + row + halo_rows", "y0 - YRC - 1 + row"),
        ("neighbour_columns", "const int o = LCOL0 + 16 * i + dx;",
         "const int o = LCOL0 + 16 * (i + 1) + dx;"),
        ("past_end_store", "if (i >= n_here) return;", "if (i >= S) return;"),
        ("group_share", "tot[m] += __shfl_sync(FULL, pick(to, m), src);",
         "tot[m] += __shfl_sync(FULL, pick(g, m), src);"),
        ("rounding_line", "cand[u][3] = __vavgu4(mc, nb[u + 1][0]);",
         "cand[u][3] = __vhaddu4(mc, nb[u + 1][0]);"),
        ("rounding_diagonal", "even = ab_e + cd_e + 0x00010001u,", "even = ab_e + cd_e,"),
        ("diagonal_twice", "cand[0][0] = diag4(pe[1][0], po[1][0], pe[0][0], po[0][0]);",
         "cand[0][0] = __vavgu4(__vavgu4(nb[1][1], nb[1][0]), __vavgu4(nb[0][1], nb[0][0]));"),
        ("odd_bytes", "__byte_perm(c, 0u, 0x4341)", "__byte_perm(c, 0u, 0x4340)"),
        ("shared_vertical", "cand[1][1] = __vavgu4(nb[1][1], nb[2][1]);",
         "cand[1][1] = __vavgu4(nb[1][1], nb[3][1]);"),
        ("intra_mean", "((pixsum >> 8) & 0xFF)", "((pixsum >> 8) & 0x7F)"),
        ("halfpel_edge_left", "bad = bad || edge_l || mvx_full == -yr;",
         "bad = bad || mvx_full == -yr;"),
        ("halfpel_edge_bottom", "bad = bad || edge_b || mvy_full == yr;",
         "bad = bad || mvy_full == yr;"),
        ("halfpel_range_left", "bad = bad || edge_l || mvx_full == -yr;", "bad = bad || edge_l;"),
        ("halfpel_range_right", "bad = bad || edge_r || mvx_full == yr;", "bad = bad || edge_r;"),
        ("halfpel_range_top", "bad = bad || edge_t || mvy_full == -yr;", "bad = bad || edge_t;"),
        ("halfpel_range_bottom", "bad = bad || edge_b || mvy_full == yr;", "bad = bad || edge_b;"),
        # Dropping the half-pel `s > 4095` has no effect, so it has no mutant:
        # the intra value, at most 0xFFF, beats every value above 4095.  Nor
        # has the window's zero fill: every candidate that reads outside the
        # plane is masked by the frame edges.
        ("substitute", "(bad || s > 4095) ? 0x1000 : s", "(bad || s > 4095) ? 0xFFF : s"),
        ("pack_halves", "hs[k] | (hs[k + 1] << 16)", "hs[k] | (hs[k + 1] << 15)"),
        ("unpack_halves", "hsum[k + 1] = (int)(s >> 16);", "hsum[k + 1] = (int)(s >> 15);"),
        ("intra_wrap", "(pixsum + hsum[9]) & 0xFFFF", "(pixsum + hsum[9]) & 0x1FFFF"),
        ("intra_clip", "vals[9] = acc < 4096 ? acc : 0xFFF;", "vals[9] = acc < 4096 ? acc : 0x1000;"),
        ("tournament_89", "(w89 <= x0123 && w89 <= x4567)", "(w89 < x0123 && w89 <= x4567)"),
        ("tournament_pair", "if (vals[1] < w01)", "if (vals[1] <= w01)"),
        ("mv_when_intra", "const int mv_x = mvx_full * 2 + hx_sel,",
         "const int mv_x = is_inter ? mvx_full * 2 + hx_sel : 0,"),
        ("iframe_pred", "grey = make_uint4(0x80808080u,", "grey = make_uint4(0x7F808080u,"),
        # F's U/V stage from the strip's chroma window
        ("chroma_shift", "8 + (mv_x >> 2) + 4 * half", "8 + (mv_x / 4) + 4 * half"),
        ("chroma_half_flag", "hx = (mv_x >> 1) & 1", "hx = (mv_x / 2) & 1"),
        ("chroma_row", "(is_v * 16 + fy) * L.cw", "(is_v * 16 + (fy ^ 1)) * L.cw"),
        ("chroma_window_halo", "(row & 15) + (halo ? 4 : 0)", "(row & 15)"),
        ("chroma_window_column", "cx = bx_s - 1 + col;", "cx = bx_s + col;"),
        # routines of both F's U/V stage and chroma_pred_kernel (one warp per
        # macroblock), then the latter's own code
        ("avg4_rounding", "(d & m) + 0x00010001u;", "(d & m);"),
        ("chroma_warp_funnel_edge", "b = __funnelshift_rc(w0, w1, sh + 8);",
         "b = __funnelshift_r(w0, w1, sh + 8);"),
        ("chroma_warp_zero", "wc4 + w) : 0u;", "wc4 + w) : 0x80808080u;"),
        ("chroma_warp_avg2", "else if (hx) return __vavgu4(a, b);",
         "else if (hx) return __vhaddu4(a, b);"),
        ("chroma_warp_avg4_twice", "if (hx && hy) return avg4(a, b, c, d);",
         "if (hx && hy) return __vavgu4(__vavgu4(a, b), __vavgu4(c, d));"),
        ("chroma_warp_shift", "(m_x >> 2) + 4 * half", "(m_x / 4) + 4 * half"),
        ("chroma_warp_halo", "(m_y >> 2) + r + halo_rows", "(m_y >> 2) + r"),
        ("chroma_warp_store", "(size_t)mb * 64 + r * 8 + 4 * half",
         "(size_t)mb * 64 + (r ^ 1) * 8 + 4 * half"),
    ]),
    "transform.cu": ("transform", [
        ("fdct_wrap17", "f[u] = ((acc & 0x1FFFF) ^ 0x10000) - 0x10000;", "f[u] = acc;"),
        ("fdct_rounding", "acc = (acc >> 12) + ((acc >> 11) & 1);", "acc = acc >> 12;"),
        ("quant_abs_wrap16", "(uint32_t)(f < 0 ? -f : f) & 0xFFFFu;",
         "(uint32_t)(f < 0 ? -f : f);"),
        ("quant_inter_wrap16", "q = ((a + 2u) & 0xFFFFu) >> (4 + q_level);",
         "q = (a + 2u) >> (4 + q_level);"),
        ("quant_intra_wrap16", "__umulhi(((a + off) & 0xFFFFu) >> q_level",
         "__umulhi((a + off) >> q_level"),
        ("dc_rounding", "q = (a >> 4) + ((a >> 3) & 1u);", "q = a >> 4;"),
        ("quant_clamp", "if (q > 2047u) q = 2047u;", "if (q > 4095u) q = 4095u;"),
        ("magic_entry", "3311782012u", "3311782011u"),
        ("zigzag_store", "zig[m][t * 64 + qt.zig[p]] = qs;", "zig[m][t * 64 + p] = qs;"),
        ("dequant_inter_clamp", "* (1 << q_level), -2047, 2047);",
         "* (1 << q_level), -4095, 4095);"),
        ("dequant_intra_clamp", "(3 - q_level),\n                -2047, 2047);",
         "(3 - q_level),\n                -4095, 4095);"),
        ("idct_trunc18", "tl[k * TS + i] = ((o[k] & 0x3FFFF) ^ 0x20000) - 0x20000;",
         "tl[k * TS + i] = o[k];"),
        ("idct_arith_shift", "return (uint32_t)((int32_t)v >> s);", "return v >> s;"),
        ("idct_clamp", "clampi(o[k], -255, 255)", "clampi(o[k], -511, 511)"),
        ("recon_clamp", "clampi((int32_t)byte_of(pw, k) + r[k], 0, 255)",
         "(((int32_t)byte_of(pw, k) + r[k]) & 255)"),
        # The IDCT's 32-bit wrap is that of its uint32 registers; no one-line
        # change of the source removes it.
    ]),
    "acsym.cu": ("acsym", [
        ("run_from_mask", "const int run = p - prev - 1;", "const int run = p - prev;"),
        ("half_mask_join", "const uint64_t mask = ((uint64_t)hi << 32) | lo;",
         "const uint64_t mask = ((uint64_t)lo << 32) | hi;"),
        ("nibble_place", "nib << ((lane & 7) * 4)", "nib << ((lane & 3) * 4)"),
        ("position0_slot", "if (p != 0) stage[", "stage["),
        ("escape_run", "((uint32_t)run << 12)", "((uint32_t)run << 11)"),
        ("escape_level12", "((uint32_t)z & 0xFFFu)", "((uint32_t)z & 0x7FFu)"),
        ("sign_bit", "| (z < 0 ? 1u : 0u);", "| 0u;"),
        ("b14_region", "if (run == 0 && am1 >= 8 && am1 <= 39)", "if (run == 0 && am1 >= 8 && am1 <= 40)"),
        ("slot_index", "stage[mbs + 4 + 65 * t + p]", "stage[mbs + 3 + 65 * t + p]"),
        ("non_ac_index", "4 + 65 * (w - 10) + 64", "4 + 65 * (w - 10) + 63"),
        ("header_at_bx0", "w < 16 + HDR_SLOTS && mb % nbx == 0", "w < 16 + HDR_SLOTS && mb % nbx == 1"),
        ("span_head", "if (tid < a0 - first) out", "if (tid + 1 < a0 - first) out"),
        ("span_tail", "if (tid < end - a1) out", "if (tid + 1 < end - a1) out"),
    ]),
    "pack.cu": ("pack", [
        ("byte_align", "bits[row] = ((long long)end + 7) & ~7LL;",
         "bits[row] = ((long long)end + 7) & ~3LL;"),
        ("code_mask", "sl[i] & ((1u << 27) - 1) & ((1u << n) - 1);", "sl[i] & ((1u << 27) - 1);"),
        ("straddle_shift", "atomicOr(&str[wi + 1], code << (64 - e));",
         "atomicOr(&str[wi + 1], code << (63 - e));"),
        ("straddle_high", "atomicOr(&str[wi], code >> (e - 32));", "atomicOr(&str[wi], code >> (e - 31));"),
        ("shared_word_atomic", "atomicOr(&str[wi], code << (32 - e));", "str[wi] = code << (32 - e);"),
        ("tile_tail", "tail = str[0] >> (32 - total);", "tail = str[0] >> (31 - total);"),
        ("window_first_word", "j ? str[j - 1] : s_win", "j ? str[j - 1] : 0u"),
        ("carry_merge", ": (uint32_t)(((unsigned long long)win << total) | tail);", ": tail;"),
        ("look_back_wait", "} while (!__all_sync(0xffffffffu, (sj & 3) != 0));", "} while (false);"),
        ("nearest_inclusive", "const int stop = incl ? __ffs(incl) - 1 : 31;",
         "const int stop = incl ? 31 - __clz(incl) : 31;"),
        ("window_position", "const uint32_t at = have + sum - val;", "const uint32_t at = have + sum;"),
        ("state_reset", "if (s_last) {", "if (false) {"),
        ("cap_test", "const int w1 = min(cap, last ?", "const int w1 = (last ?"),
        ("zero_fill_cap", "w < cap; w += PACK_THREADS) out[w] = 0;",
         "w < cap - 1; w += PACK_THREADS) out[w] = 0;"),
        ("fill_skipped", "    if (fill)\n", "    if (false)\n"),
        # the two operands (the gop program's pack_rows) and its rows written
        # only up to their last partial word
        ("header_row_from_slices", "const uint32_t* __restrict__ slots = in_head ? head : body;",
         "const uint32_t* __restrict__ slots = body;"),
        ("slice_row0_from_header", "const bool in_head = row < n_head;",
         "const bool in_head = row <= n_head;"),
        ("last_partial_word_unwritten", "last ? (end + 31) >> 5 : end >> 5", "end >> 5"),
        ("bits_past_end_kept", "i < (total + 31) / 32 + 2; i += PACK_THREADS) str[i] = 0;",
         "i < (total + 31) / 32; i += PACK_THREADS) str[i] = 0;"),
        # the merge kernel (merge_rows and merge_append)
        ("merge_row_scan", "if (i < m.r) start[i + 1] = before + x;",
         "if (i < m.r) start[i + 1] = before + x - own;"),
        ("merge_row_words", "(long long)m.c);", "(long long)m.c + 1);"),
        ("merge_seq_residue", "s = (int)(sb & 31);", "s = (int)(sb & 15);"),
        ("merge_first_word_or", "m.out[off + j] |= v;", "m.out[off + j] = v;"),
        ("merge_cap_cut", "if (keep < 32) v = keep > 0", "if (keep < 0) v = keep > 0"),
        ("merge_clamp", "off = min(sb >> 5, last);", "off = (sb >> 5) % (last + 1);"),
        # A status word carries its data with its state in one 64-bit store,
        # so a publish needs no fence.  The last block's wait for each
        # inclusive publish before it clears the word has no mutant: without
        # it, a publish could land after the clear only under a reordering
        # of the memory system that no test can provoke at will.
    ]),
    "glue.cu": ("glue", [
        # a length >= 16 sets a slot's sign bit as int32: kept in uint32
        ("slot_len_high_bit", "return code | (len << 27);", "return code | ((len & 15u) << 27);"),
        ("mv_wrap", "+ 16u) & 31u) - 16;", "+ 15u) & 31u) - 15;"),
        ("mv_pred_row_start", "const bool left_inter = bx > 0 && inter[mb - 1];",
         "const bool left_inter = mb > 0 && inter[mb - 1];"),
        ("dc_negative_diff", "val = (val + (1u << vallen) - 1u) & 0xFFFu;",
         "val = (val + (1u << vallen)) & 0xFFFu;"),
        # Dropping the mask to vallen bits has no effect (after the 12-bit
        # wrap the value is already below 2^vallen, for every difference in
        # +-2^16), so its mutant masks one bit too few.
        ("dc_value_mask", "val &= (1u << vallen) - 1u;", "val &= (1u << vallen) - 2u;"),
        ("dc_size_12", "for (int k = 0; k < 12; k++) vallen", "for (int k = 0; k < 11; k++) vallen"),
        ("dc_pred_tile3", "const int t = lane == 0 ? 3 : lane;", "const int t = lane == 0 ? 0 : lane;"),
        ("dc_pred_row_start", "const bool left_intra = bx > 0 && !inter[mb - 1];",
         "const bool left_intra = mb > 0 && !inter[mb - 1];"),
        ("hour_clamp", "min(fno / (24 * 3600), 63)", "min(fno / (24 * 3600), 64)"),
        ("minute_wrap", "((fno / (24 * 60)) % 60)", "((fno / (24 * 60)) % 64)"),
        ("temporal_ref", "case 8: dyn = (uint32_t)i_f; break;", "case 8: dyn = 0u; break;"),
        ("intra_type_in_p", "intra && is_p ? slot(0x23u, 6u)", "intra ? slot(0x23u, 6u)"),
        ("eob_gated_by_nz", "slot(2u, 2u * ((nz >> lane) & 1u))", "slot(2u, 2u)"),
        ("inter_dc_minus_one", "else if (dc == 1 || dc == -1)", "else if (dc == 1)"),
        ("inter_dc_zero_empty", "dc_slot = put_ac_run0(1, s_ac) & ((1u << 27) - 1);",
         "dc_slot = put_ac_run0(1, s_ac);"),
        ("inter_dc_b14_edge", "am1 <= 39 ? (int)am1 + 56", "am1 <= 40 ? (int)am1 + 56"),
        ("cbp_bit_order", "const uint32_t cbp = __brev(nz) >> 26;", "const uint32_t cbp = nz;"),
        ("emit_flag", "o.x = intra || o.x != 0;", "o.x = o.x != 0;"),
        ("slice_row_number", "(uint32_t)(first_row + mb / nbx)", "(uint32_t)(mb / nbx)"),
        ("span_head", "if (tid < a0 - first) small", "if (tid + 1 < a0 - first) small"),
        ("span_tail", "if (tid < end - a1) small", "if (tid + 1 < end - a1) small"),
        ("header_tail", "for (int i = 0; i < stop - w; i++)", "for (int i = 0; i + 1 < stop - w; i++)"),
    ]),
    "subsample.cu": ("subsample", [
        ("rounding_plus_one", "return __vavgu4(lower, upper);", "return __vhaddu4(lower, upper);"),
        ("rounding_order", "__vavgu4(te, to), lower = __vavgu4(be, bo);",
         "__vavgu4(te, be), lower = __vavgu4(to, bo);"),
        ("pair_bytes", "__byte_perm(t0, t1, 0x6420)", "__byte_perm(t0, t1, 0x5420)"),
        ("second_row", "*reinterpret_cast<const uint4*>(src + w);",
         "*reinterpret_cast<const uint4*>(src + 2 * w);"),
        ("output_column", "(long long)r * (w / 2) + 8 * g", "(long long)r * (w / 2) + 4 * g"),
        ("plane_select", "(second ? v : u)", "(second ? u : v)"),
        # the stack entry's own code: the frame, the table, the Y copy
        ("stack_frame_before", "const long long f = *k;", "const long long f = *k - 1;"),
        ("stack_plane_stride", "f * planes[2 * p + 1]", "f * planes[1]"),
        ("stack_y_skipped", "reinterpret_cast<uint4*>(yo)[j] = src[j];", "(void)src;"),
        ("stack_y_shifted", "(yo)[j] = src[j];", "(yo)[j] = src[j + 1];"),
    ]),
    "carry.cu": ("carry", [
        ("gop_wrap", "pos >= pframes ? 0", "pos > pframes ? 0"),
        ("scatter_index", "a.frame_bits[k] = fbits;", "a.frame_bits[0] = fbits;"),
        ("scatter_index_ifs", "a.frame_ifs[k] = pos;", "a.frame_ifs[0] = pos;"),
        ("seq_bits_carry", "*a.seq_bits = new_bits;", "*a.seq_bits = fbits;"),
        ("row_overflow_or", "over_before || row_over || frame_over",
         "over_before || frame_over"),
        ("row_overflow_at_cap", "a.row_bits[i] > cap_bits", "a.row_bits[i] >= cap_bits"),
        ("row_lanes", "i < a.r; i += 32)", "i < a.r; i += 64)"),
        ("frame_overflow_or", "row_over || frame_over;", "row_over;"),
        ("overflow_sticky", "*a.overflow = over_before || row_over", "*a.overflow = row_over"),
        ("frame_no_increment", "(uint32_t)frame_no + 1u", "(uint32_t)frame_no"),
        ("k_advance", "*a.k = k + 1;", "*a.k = k;"),
    ]),
}


def substituted(source, subs, name):
    """The text of csrc/``source`` with each (text, replacement) of ``subs``
    applied; each text must occur exactly once."""
    with open(os.path.join(PKG, "csrc", source)) as f:
        src = f.read()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} occurs {src.count(old)} times in {source}")
        src = src.replace(old, new)
    return src


def run(source, select, name, old=None, new=None):
    """Copy the package and the card tests, apply the mutant, run the tests:
    (pytest's exit code, its last line)."""
    d = os.path.join(WORK, source.split(".")[0] + "-" + name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(d, "fpga_mpeg2_encoder_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    os.makedirs(os.path.join(d, "tests"))
    shutil.copy(os.path.join(ROOT, "tests", "test_torch_cuda.py"), os.path.join(d, "tests"))
    if old is not None:
        src = substituted(source, [(old, new)], name)
        with open(os.path.join(d, "fpga_mpeg2_encoder_tpu_torch", "csrc", source), "w") as f:
            f.write(src)
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
         "-x", "-k", select, "tests/test_torch_cuda.py"],
        cwd=d, env={**os.environ, "PYTHONPATH": d}, capture_output=True, text=True,
        timeout=900)
    lines = res.stdout.strip().splitlines()
    return res.returncode, lines[-1] if lines else res.stderr.strip()[-200:]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", choices=sorted(MUTANTS), help="kernel source under csrc/")
    ap.add_argument("--jobs", type=int, default=4, help="mutants run at once")
    args = ap.parse_args()
    select, mutants = MUTANTS[args.source]
    rc, last = run(args.source, select, "baseline")
    print(f"baseline: pytest rc={rc} {last}", flush=True)
    if rc != 0:
        return 1
    missed = []
    with ThreadPoolExecutor(args.jobs) as pool:
        futs = [(m[0], pool.submit(run, args.source, select, *m)) for m in mutants]
        for name, fut in futs:
            rc, last = fut.result()
            caught = rc == 1 and "failed" in last
            if not caught:
                missed.append(name)
            print(f"mutant {name}: pytest rc={rc} {'caught' if caught else 'MISSED'} | {last}",
                  flush=True)
    print(f"{args.source}: {len(mutants) - len(missed)} of {len(mutants)} mutants caught"
          + (f"; missed: {', '.join(missed)}" if missed else ""))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
