"""Interpolation operator construction (SURVEY.md §2 C12).

Classical direct interpolation with +/- splitting (BoomerAMG convention):
for an F-point i and strong C-neighbour j,
    w_ij = -alpha * a_ij / d_ii   (a_ij < 0),   alpha = sum(neg offdiag)/sum(neg over C_i)
    w_ij = -beta  * a_ij / d_ii   (a_ij > 0),   beta likewise for positive parts;
if no positive C connections exist, positive off-diagonal mass is lumped into
the diagonal d_ii.  C-points use injection.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .._native import get_lib, csr_arrays
from .splitting import CPT


def direct_interpolation(A: sp.csr_matrix, strong_mask: np.ndarray,
                         cf: np.ndarray) -> sp.csr_matrix:
    """Build P (n x n_coarse) from A, the strength mask, and a C/F split."""
    n = A.shape[0]
    is_c = cf == CPT
    n_c = int(is_c.sum())
    cmap = np.cumsum(is_c, dtype=np.int64) - 1  # coarse index of each C-point
    cmap32 = cmap.astype(np.int32)

    lib = get_lib()
    if lib is not None:
        indptr, indices, data = csr_arrays(A)
        cap = len(indices) + n
        P_indptr = np.empty(n + 1, dtype=np.int64)
        P_indices = np.empty(cap, dtype=np.int32)
        P_data = np.empty(cap, dtype=np.float64)
        nnz = lib.direct_interp(
            n, indptr, indices, data,
            np.ascontiguousarray(strong_mask, dtype=np.uint8),
            np.ascontiguousarray(cf, dtype=np.int8), cmap32,
            P_indptr, P_indices, P_data)
        return sp.csr_matrix(
            (P_data[:nnz], P_indices[:nnz], P_indptr), shape=(n, n_c))

    return _direct_interp_numpy(A, strong_mask, cf, cmap, n_c)


def truncate_rows(P: sp.csr_matrix, max_per_row: int) -> sp.csr_matrix:
    """Interpolation truncation (hypre's P_max_elmts): keep the
    `max_per_row` largest-|w| entries per row, rescaling so the positive
    and negative row sums are separately preserved.  This is what keeps
    Galerkin operator complexity bounded on 3-D problems — without it
    RS+direct RAP densifies (~270 nnz/row observed at level 5 on a 64^3
    Poisson)."""
    if max_per_row <= 0 or P.nnz == 0:
        return P
    nnzr = np.diff(P.indptr)
    if nnzr.max() <= max_per_row:
        return P
    n = P.shape[0]
    lib = get_lib()
    if lib is not None:
        indptr, indices, data = csr_arrays(P)
        out_nnz = int(np.minimum(nnzr, max_per_row).sum())
        O_indptr = np.empty(n + 1, dtype=np.int64)
        O_indices = np.empty(out_nnz, dtype=np.int32)
        O_data = np.empty(out_nnz, dtype=np.float64)
        lib.truncate_interp(n, indptr, indices, data, int(max_per_row),
                            O_indptr, O_indices, O_data)
        return sp.csr_matrix((O_data, O_indices, O_indptr), shape=P.shape)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnzr)
    # rank within rows via a padded (n, K) slot table + per-row argsort —
    # K is small (max nnz/row), so this is O(n K log K) with short C sorts
    # instead of one global lexsort over every nnz
    K = int(nnzr.max())
    slot = np.arange(P.nnz, dtype=np.int64) - np.repeat(
        P.indptr[:-1].astype(np.int64), nnzr)
    table = np.zeros((n, K))
    table[rows, slot] = np.abs(P.data)
    top = np.argsort(-table, axis=1, kind="stable")[:, :max_per_row]
    keep2d = np.zeros((n, K), dtype=bool)
    keep2d[np.arange(n)[:, None], top] = True
    keep = keep2d[rows, slot]

    def rowsum(mask):
        out = np.zeros(n)
        np.add.at(out, rows, np.where(mask, P.data, 0.0))
        return out

    pos, neg = P.data > 0, P.data < 0
    with np.errstate(divide="ignore", invalid="ignore"):
        s_pos = rowsum(pos) / rowsum(pos & keep)
        s_neg = rowsum(neg) / rowsum(neg & keep)
    s_pos = np.where(np.isfinite(s_pos), s_pos, 1.0)
    s_neg = np.where(np.isfinite(s_neg), s_neg, 1.0)
    data = np.where(pos, P.data * s_pos[rows], P.data * s_neg[rows])[keep]
    out = sp.csr_matrix((data, P.indices[keep],
                         np.concatenate([[0], np.cumsum(
                             np.bincount(rows[keep], minlength=n))])),
                        shape=P.shape)
    return out


def extpi_interpolation(A: sp.csr_matrix, strong_mask: np.ndarray,
                        cf: np.ndarray) -> sp.csr_matrix:
    """Extended+i (distance-two) interpolation.

    The standard pairing for aggressive PMIS/HMIS coarsening (De Sterck,
    Falgout, Nolting & Yang 2008; hypre interp_type 6): an F-point i
    interpolates from Ĉ_i = C^s_i ∪ (∪_{k∈F^s_i} C^s_k) — its strong
    C-neighbours plus those of its strong F-neighbours — with each strong
    F-neighbour k's connection distributed over Ĉ_i ∪ {i}:

        w_ij = -(a_ij + Σ_{k∈F^s_i} a_ik·ā_kj/d_k) / D_i
        d_k  = Σ_{l∈Ĉ_i∪{i}} ā_kl          (ā_kl: sign-opposite-to-a_kk part)
        D_i  = a_ii + Σ_{weak n} a_in + Σ_{k∈F^s_i} a_ik·ā_ki/d_k

    PMIS leaves F-points whose nearest C-point is two hops away; direct
    interpolation is too weak there, which is why RS+direct densifies
    (opC 3.4 in round 1) while PMIS+ext+i holds opC ≲ 1.6 on 3-D Poisson.
    """
    n = A.shape[0]
    is_c = cf == CPT
    n_c = int(is_c.sum())
    cmap = np.cumsum(is_c, dtype=np.int64) - 1

    lib = get_lib()
    if lib is not None:
        indptr, indices, data = csr_arrays(A)
        strong_u8 = np.ascontiguousarray(strong_mask, dtype=np.uint8)
        cf_i8 = np.ascontiguousarray(cf, dtype=np.int8)
        cmap32 = cmap.astype(np.int32)
        P_indptr = np.empty(n + 1, dtype=np.int64)
        nnz = lib.extpi_symbolic(n, indptr, indices, strong_u8, cf_i8,
                                 P_indptr)
        P_indices = np.empty(nnz, dtype=np.int32)
        P_data = np.empty(nnz, dtype=np.float64)
        lib.extpi_numeric(n, indptr, indices, data, strong_u8, cf_i8,
                          cmap32, P_indptr, P_indices, P_data)
        P = sp.csr_matrix((P_data, P_indices, P_indptr), shape=(n, n_c))
        P.eliminate_zeros()
        return P

    return _extpi_numpy(A, strong_mask, cf, cmap, n_c)


def _extpi_numpy(A, strong_mask, cf, cmap, n_c):
    """Row-loop reference implementation (test oracle; small n only)."""
    n = A.shape[0]
    indptr, indices, data = A.indptr, A.indices, A.data
    rows_out, cols_out, vals_out = [], [], []
    diag = A.diagonal()

    def row(i):
        sl = slice(indptr[i], indptr[i + 1])
        return indices[sl], data[sl], strong_mask[sl]

    for i in range(n):
        if cf[i] == CPT:
            rows_out.append(i)
            cols_out.append(cmap[i])
            vals_out.append(1.0)
            continue
        cols_i, vals_i, str_i = row(i)
        off = cols_i != i
        strongC = str_i & (cf[cols_i] == CPT)
        strongF = str_i & (cf[cols_i] != CPT) & off
        # extended C set
        chat = set(cols_i[strongC].tolist())
        for k in cols_i[strongF]:
            ck, vk, sk = row(k)
            chat.update(ck[sk & (cf[ck] == CPT)].tolist())
        if not chat:
            continue
        acc = {j: 0.0 for j in chat}
        # direct terms a_ij for j in chat
        for j, v in zip(cols_i[off], vals_i[off]):
            if j in acc:
                acc[j] += v
        D = diag[i]
        for idx in range(len(cols_i)):
            k, a_ik = cols_i[idx], vals_i[idx]
            if k == i:
                continue
            if strongF[idx]:
                ck, vk, _ = row(k)
                abar = np.where(vk * diag[k] < 0, vk, 0.0)
                in_set = np.array([(c in acc) or (c == i) for c in ck])
                d_k = abar[in_set].sum()
                if d_k == 0.0:
                    D += a_ik          # lump: k has no path back
                    continue
                f = a_ik / d_k
                for c, ab in zip(ck, abar):
                    if ab == 0.0:
                        continue
                    if c == i:
                        D += f * ab
                    elif c in acc:
                        acc[c] += f * ab
            elif k not in acc:
                D += a_ik              # weak, outside chat: lump
        if D == 0.0:
            continue
        for j, num in acc.items():
            w = -num / D
            if w != 0.0:
                rows_out.append(i)
                cols_out.append(cmap[j])
                vals_out.append(w)
    P = sp.coo_matrix((vals_out, (rows_out, cols_out)),
                      shape=(n, n_c)).tocsr()
    return P


def _direct_interp_numpy(A, strong_mask, cf, cmap, n_c):
    """Vectorized numpy fallback (same formula as the native kernel)."""
    n = A.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    dmask = A.indices == rows
    is_c_col = cf[A.indices] == CPT
    offdiag = ~dmask
    neg, pos = A.data < 0, A.data > 0
    interp_entry = strong_mask & is_c_col & offdiag

    def rowsum(m):
        out = np.zeros(n)
        np.add.at(out, rows, np.where(m, A.data, 0.0))
        return out

    diag = rowsum(dmask)
    sum_neg_all = rowsum(offdiag & neg)
    sum_pos_all = rowsum(offdiag & pos)
    sum_neg_C = rowsum(interp_entry & neg)
    sum_pos_C = rowsum(interp_entry & pos)

    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(sum_neg_C != 0, sum_neg_all / sum_neg_C, 0.0)
        beta = np.where(sum_pos_C != 0, sum_pos_all / sum_pos_C, 0.0)
    diag = diag + np.where(sum_pos_C == 0, sum_pos_all, 0.0)

    coef = np.where(A.data < 0, alpha[rows], beta[rows])
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(diag[rows] != 0, -coef * A.data / diag[rows], 0.0)

    keep = interp_entry & (w != 0) & (cf[rows] != CPT)
    # F-point rows
    f_rows = rows[keep]
    f_cols = cmap[A.indices[keep]]
    f_vals = w[keep]
    # C-point injection rows
    c_idx = np.where(cf == CPT)[0]
    P = sp.coo_matrix(
        (np.concatenate([f_vals, np.ones(len(c_idx))]),
         (np.concatenate([f_rows, c_idx]),
          np.concatenate([f_cols, cmap[c_idx]]))),
        shape=(n, n_c)).tocsr()
    P.sum_duplicates()
    return P


def multipass_interpolation(A: sp.csr_matrix, strong_mask: np.ndarray,
                            cf: np.ndarray, max_per_row: int = 5,
                            smooth_omega: float | None = None
                            ) -> sp.csr_matrix:
    """Multipass interpolation (Stuben 2001; hypre agg_interp_type 4) —
    the standard partner of aggressive (two-round PMIS) coarsening.

    Builds P directly from the fine A and the FINAL C/F split, with no
    intermediate Galerkin operator: pass-1 F-points (strong C neighbour)
    get direct interpolation; pass-p F-points distribute their strong
    connections over already-interpolated neighbours' P rows, lumping
    weak/unreachable connections into the diagonal.  Rows are truncated
    to ``max_per_row`` as built (pos/neg row sums separately preserved).
    """
    n = A.shape[0]
    is_c = cf == CPT
    n_c = int(is_c.sum())
    cmap = np.cumsum(is_c, dtype=np.int64) - 1

    lib = get_lib()
    if lib is not None:
        indptr, indices, data = csr_arrays(A)
        strong_u8 = np.ascontiguousarray(strong_mask, dtype=np.uint8)
        cf_i8 = np.ascontiguousarray(cf, dtype=np.int8)
        cmap32 = cmap.astype(np.int32)
        from .._native import empty_prefaulted
        cap = int(max_per_row)
        P_cols = empty_prefaulted((n, cap), np.int32)
        P_vals = empty_prefaulted((n, cap), np.float64)
        P_len = np.empty(n, dtype=np.int32)
        lib.multipass_interp(n, indptr, indices, data, strong_u8, cf_i8,
                             cmap32, n_c, cap, P_cols.reshape(-1),
                             P_vals.reshape(-1), P_len)
        if smooth_omega:
            # fused damped-Jacobi repair pass in the same slot layout
            # (see interp_jacobi_smooth; a generic-SpGEMM formulation of
            # the identical update cost 10 s at 192^3 in per-row hash
            # setup for these <= cap-entry rows)
            Q_cols = empty_prefaulted((n, cap), np.int32)
            Q_vals = empty_prefaulted((n, cap), np.float64)
            Q_len = np.empty(n, dtype=np.int32)
            lib.interp_jacobi_smooth(n, indptr, indices, data, strong_u8,
                                     float(smooth_omega), n_c, cap,
                                     P_cols.reshape(-1),
                                     P_vals.reshape(-1), P_len,
                                     Q_cols.reshape(-1),
                                     Q_vals.reshape(-1), Q_len)
            P_cols, P_vals, P_len = Q_cols, Q_vals, Q_len
        lens = P_len.astype(np.int64)
        P_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=P_indptr[1:])
        nnz = int(P_indptr[-1])
        P_indices = empty_prefaulted(nnz, np.int32)
        P_data = empty_prefaulted(nnz, np.float64)
        lib.slot_compact(n, cap, P_cols.reshape(-1), P_vals.reshape(-1),
                         P_len, P_indptr, P_indices, P_data)
        P = sp.csr_matrix((P_data, P_indices, P_indptr), shape=(n, n_c))
        P.sort_indices()      # rows come out in discovery order
        return P

    P = _multipass_numpy(A, strong_mask, cf, cmap, n_c, max_per_row)
    if smooth_omega:
        P = smooth_truncate(A, P, strong_mask, smooth_omega, max_per_row)
    return P


def _multipass_numpy(A, strong_mask, cf, cmap, n_c, max_per_row):
    """Reference implementation (test oracle; small n only)."""
    n = A.shape[0]
    A = A.tocsr()
    indptr, indices, data = A.indptr, A.indices, A.data
    passno = np.where(cf == CPT, 0, -1)
    rows: list[dict] = [dict() for _ in range(n)]
    for i in np.where(cf == CPT)[0]:
        rows[i] = {int(cmap[i]): 1.0}

    def truncate(d):
        if len(d) <= max_per_row:
            return d
        # tie-break on insertion order, matching the native slot order
        items = sorted(enumerate(d.items()),
                       key=lambda t: (-abs(t[1][1]), t[0]))
        kept = dict(kv for _, kv in items[:max_per_row])
        for sign in (1, -1):
            tot = sum(v for v in d.values() if v * sign > 0)
            ktot = sum(v for v in kept.values() if v * sign > 0)
            if ktot:
                for c in kept:
                    if kept[c] * sign > 0:
                        kept[c] *= tot / ktot
        return kept

    p = 1
    while True:
        cur = []
        for i in range(n):
            if passno[i] >= 0:
                continue
            sl = slice(indptr[i], indptr[i + 1])
            js = indices[sl]
            st = strong_mask[sl]
            if any(st[k] and js[k] != i and 0 <= passno[js[k]] < p
                   for k in range(len(js))):
                cur.append(i)
        if not cur:
            break
        for i in cur:
            sl = slice(indptr[i], indptr[i + 1])
            js, vs, st = indices[sl], data[sl], strong_mask[sl]
            if p == 1:
                diag = sneg_all = spos_all = sneg_C = spos_C = 0.0
                for j, v, s in zip(js, vs, st):
                    if j == i:
                        diag += v
                        continue
                    if v < 0:
                        sneg_all += v
                    else:
                        spos_all += v
                    if s and cf[j] == CPT:
                        if v < 0:
                            sneg_C += v
                        else:
                            spos_C += v
                alpha = sneg_all / sneg_C if sneg_C else 0.0
                if spos_C:
                    beta = spos_all / spos_C
                else:
                    beta = 0.0
                    diag += spos_all
                d = {}
                if diag:
                    for j, v, s in zip(js, vs, st):
                        if j == i or not s or cf[j] != CPT:
                            continue
                        w = (-alpha if v < 0 else -beta) * v / diag
                        if w:
                            d[int(cmap[j])] = d.get(int(cmap[j]), 0.0) + w
                rows[i] = truncate(d)
            else:
                denom = 0.0
                acc: dict = {}
                for j, v, s in zip(js, vs, st):
                    if j == i:
                        denom += v
                        continue
                    if s and 0 <= passno[j] < p and rows[j]:
                        for c, w in rows[j].items():
                            acc[c] = acc.get(c, 0.0) + v * w
                    else:
                        denom += v
                d = {}
                if denom:
                    for c, w in acc.items():
                        if w:
                            d[c] = -w / denom
                rows[i] = truncate(d)
        for i in cur:
            passno[i] = p
        p += 1

    P = sp.lil_matrix((n, n_c))
    for i, d in enumerate(rows):
        for c, w in d.items():
            P[i, c] = w
    return P.tocsr()


def smooth_truncate(A: sp.csr_matrix, P: sp.csr_matrix,
                    strong_mask: np.ndarray, omega: float = 2.0 / 3.0,
                    max_per_row: int = 5) -> sp.csr_matrix:
    """One damped-Jacobi smoothing pass over an interpolation P, against
    the strength-FILTERED operator, then row truncation — the quality
    repair for multipass interpolation (measured on 96^3 Poisson: 28 ->
    20 PCG iterations, matching composed ext+i).

    With A_f = A_strong + diag(d + lump) (weak off-diagonals lumped),
    P' = (I - omega D_f^-1 A_f) P = (1-omega) P - omega D_f^-1 A_strong P,
    since D_f = diag(A_f).  The identity keeps the hot path native: one
    masked compress, one OpenMP SpGEMM, two row scalings, one CSR add —
    no nnz-length rows array and no serial scipy SpGEMM."""
    lib = get_lib()
    if lib is None:
        from .aggregate import smooth_prolongator
        return truncate_rows(
            smooth_prolongator(A, P, omega, strong_mask=strong_mask),
            max_per_row)
    from .galerkin import spgemm, csr_add
    n = A.shape[0]
    indptr, indices, data = csr_arrays(A)
    strong_u8 = np.ascontiguousarray(strong_mask, dtype=np.uint8)
    Sp = np.empty(n + 1, dtype=np.int64)
    lib.mask_indptr(n, indptr, strong_u8, Sp)
    nnz_s = int(Sp[-1])
    Si = np.empty(nnz_s, dtype=np.int32)
    Sd = np.empty(nnz_s, dtype=np.float64)
    lib.mask_compress_data(n, indptr, indices, data, strong_u8, Sp, Si, Sd)
    A_s = sp.csr_matrix((Sd, Si, Sp), shape=A.shape)
    A_s.has_sorted_indices = True     # sub-sequence of sorted rows
    d = A.diagonal()
    lump = np.empty(n)
    lib.weak_row_sum(n, indptr, indices, data, strong_u8, lump)
    D_f = d + lump
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(D_f != 0, -omega / D_f, 0.0)
    M = spgemm(A_s, P)
    Mp = np.ascontiguousarray(M.indptr, dtype=np.int64)
    lib.csr_row_scale(M.shape[0], Mp,
                      np.ascontiguousarray(M.data, dtype=np.float64),
                      np.ascontiguousarray(scale))
    P_new = csr_add(1.0 - omega, P.tocsr(), 1.0, M)
    return truncate_rows(P_new, max_per_row)
