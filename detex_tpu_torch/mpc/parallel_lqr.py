"""Parallel (log-depth) LQR and LQT backward passes, single device.

Counterpart of detex_tpu/mpc/parallel_lqr.py.  The Riccati
backward pass is a recursion of depth H; written as an associative
combination of conditional value-function elements it runs in
ceil(log2(H + 1)) levels of batched combines.  (Cf. Särkkä and
García-Fernández, temporal parallelization of LQR.)

Element (A, b, C, eta, J) represents the optimal cost-to-go between two
times conditioned on both endpoint states; combination eliminates the
intermediate state:

  A12 = A2 M A1            M  = (I + C1 J2)^{-1}
  b12 = A2 M (b1 + C1 eta2) + b2
  C12 = A2 M C1 A2' + C2
  e12 = A1' N (eta2 - J2 b1) + eta1     N = (I + J2 C1)^{-1}
  J12 = A1' N J2 A1 + J1

For linear dynamics x' = F x + L u + c with stage cost 0.5 x'X x +
0.5 u'U u, the suffix-combined element at time k gives the value Hessian
P_k = J_k* and value gradient -eta_k*.

torch has no associative scan, so `_suffix_scan` is a Hillis-Steele scan
over the element tensors: at level d every element k with k + d <= H is
combined with element k + d, one batched combine per level.  The
combination order differs from jax.lax.associative_scan's, so the two
agree to float rounding, not bit for bit.  The inverses and solves use
the `_ex` forms, which do not read an error flag back to the host (a
singular system gives non-finite values, as in the JAX package).

lqt_backward_parallel_sharded splits the horizon over the ranks of a mesh
axis: a local suffix scan per rank, one all_gather of the chunk totals,
and one combine with the later chunks' suffix.
"""

from __future__ import annotations

import torch

from detex_tpu_torch.parallel import mesh as mesh_mod

Elements = tuple


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(a, b)[0]


def _inv(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(a)[0]


def _combine(e1: Elements, e2: Elements) -> Elements:
    """Associative combination, batched over the leading axes; e1 covers
    the earlier interval."""
    a1, b1, c1, eta1, j1 = e1
    a2, b2, c2, eta2, j2 = e2
    n = a1.shape[-1]
    eye = torch.eye(n, dtype=a1.dtype, device=a1.device)
    m = _solve(eye + c1 @ j2, eye.expand_as(c1))
    nmat = _solve(eye + j2 @ c1, eye.expand_as(c1))
    a12 = a2 @ m @ a1
    b12 = (a2 @ m @ (b1[..., None] + c1 @ eta2[..., None]))[..., 0] + b2
    c12 = a2 @ m @ c1 @ _t(a2) + c2
    eta12 = (_t(a1) @ nmat @ (eta2[..., None]
                              - j2 @ b1[..., None]))[..., 0] + eta1
    j12 = _t(a1) @ nmat @ j2 @ a1 + j1
    return a12, b12, c12, eta12, j12


def _suffix_scan(elems: Elements) -> Elements:
    """out[k] = e_k (+) e_{k+1} (+) ... (+) e_last for every k, in
    ceil(log2(len)) levels of batched combines."""
    total = elems[0].shape[0]
    d = 1
    while d < total:
        head = _combine(tuple(e[:total - d] for e in elems),
                        tuple(e[d:] for e in elems))
        elems = tuple(torch.cat([h, e[total - d:]]) for h, e in
                      zip(head, elems))
        d *= 2
    return elems


def lqr_backward_parallel(f_mat, l_mat, c_vec, x_cost, u_cost, x_terminal):
    """Backward value functions for a (time-varying) LQR in parallel.

    f_mat (H, n, n), l_mat (H, n, m), c_vec (H, n), x_cost (H, n, n),
    u_cost (H, m, m), x_terminal (n, n).
    Returns (P (H+1, n, n), eta (H+1, n)) with P_k the value Hessian at
    time k (P_H = x_terminal) and value gradient -eta_k."""
    h, n, _ = f_mat.shape
    u_inv = _inv(u_cost)
    c_elem = l_mat @ u_inv @ _t(l_mat)
    zmat = f_mat.new_zeros((1, n, n))
    zvec = f_mat.new_zeros((1, n))
    elems = (torch.cat([f_mat, zmat]), torch.cat([c_vec, zvec]),
             torch.cat([c_elem, zmat]), f_mat.new_zeros((h + 1, n)),
             torch.cat([x_cost, x_terminal[None]]))
    _, _, _, eta, j = _suffix_scan(elems)
    return j, eta


def lqr_gains_from_value(f_mat, l_mat, c_vec, u_cost, p_next, eta_next):
    """Feedback/feedforward gains from the next-step value function:
    u_k = -K_k x_k - k_k."""
    lt = _t(l_mat)
    quu = u_cost + lt @ p_next @ l_mat
    k_fb = _solve(quu, lt @ p_next @ f_mat)
    rhs = lt @ (p_next @ c_vec[..., None] - eta_next[..., None])
    k_ff = _solve(quu, rhs)[..., 0]
    return k_fb, k_ff


def lqt_backward_parallel(f_mat, l_mat, c_vec, q_mat, q_vec, r_mat,
                          r_vec, m_mat, p_term, p_vec_term):
    """General parallel LQT backward pass (linear and cross cost terms).

    Stage k: dynamics x+ = F x + L u + c, cost
        0.5 x'Q x + q'x + 0.5 u'R u + r'u + u'M x
    terminal 0.5 x'P_T x + p_T'x.  All per-stage args (H, ...).

    This is iLQR's Gauss-Newton subproblem: Q=lxx, q=lx, R=luu(+reg),
    r=lu, M=lux around the current trajectory.  The cross and
    control-linear terms fold into the state cost by the substitution
    u = v - R^{-1}(M x + r) (see _lqt_elements), after which the element
    scan of lqr_backward_parallel applies with eta seeded from the linear
    terms (value gradient at x is P_k x - eta_k).

    Returns (P (H+1, n, n), eta (H+1, n))."""
    elems = _lqt_elements(f_mat, l_mat, c_vec, q_mat, q_vec, r_mat,
                          r_vec, m_mat, p_term, p_vec_term)
    _, _, _, eta, j = _suffix_scan(elems)
    return j, eta


def _lqt_elements(f_mat, l_mat, c_vec, q_mat, q_vec, r_mat, r_vec,
                  m_mat, p_term, p_vec_term) -> Elements:
    """Per-stage conditional value elements of the general LQT (H+1
    entries; the last is the terminal cost):

        Q~ = Q - M'R^{-1}M   q~ = q - M'R^{-1}r
        F~ = F - L R^{-1}M   c~ = c - L R^{-1}r
    """
    h, n, _ = f_mat.shape
    r_inv = _inv(r_mat)
    ri_m = r_inv @ m_mat
    ri_r = (r_inv @ r_vec[..., None])[..., 0]
    mt = _t(m_mat)
    q_t = q_mat - mt @ ri_m
    qv_t = q_vec - (mt @ ri_r[..., None])[..., 0]
    f_t = f_mat - l_mat @ ri_m
    c_t = c_vec - (l_mat @ ri_r[..., None])[..., 0]
    c_elem = l_mat @ r_inv @ _t(l_mat)
    zmat = f_mat.new_zeros((1, n, n))
    zvec = f_mat.new_zeros((1, n))
    return (torch.cat([f_t, zmat]), torch.cat([c_t, zvec]),
            torch.cat([c_elem, zmat]), torch.cat([-qv_t, -p_vec_term[None]]),
            torch.cat([q_t, p_term[None]]))


def _identity_elements(k: int, n: int, dtype=torch.float32,
                       device=None) -> Elements:
    """k identity elements: combine(e, id) == e == combine(id, e)."""
    eye = torch.eye(n, dtype=dtype, device=device).expand(k, n, n)
    zmat = torch.zeros((k, n, n), dtype=dtype, device=device)
    zvec = torch.zeros((k, n), dtype=dtype, device=device)
    return (eye, zvec, zmat, zvec, zmat)


def _flat(elems: Elements) -> torch.Tensor:
    return torch.cat([e.reshape(-1) for e in elems])


def _unflat(buf: torch.Tensor, like: Elements) -> Elements:
    """(m, sum of sizes) -> the elements' tensors with a leading m."""
    out, offset = [], 0
    for e in like:
        out.append(buf[:, offset:offset + e.numel()]
                   .reshape(buf.shape[0], *e.shape))
        offset += e.numel()
    return tuple(out)


def lqt_backward_parallel_sharded(f_mat, l_mat, c_vec, q_mat, q_vec, r_mat,
                                  r_vec, m_mat, p_term, p_vec_term, mesh,
                                  axis: str = "sp",
                                  gather_output: bool = True):
    """Horizon-sharded parallel LQT backward (counterpart of
    detex_tpu/mpc/parallel_lqr.py:148-231), run by every rank of `axis`
    on the same (replicated) arguments as lqt_backward_parallel.

    The H+1 value elements, padded with identity elements after the
    terminal one to a multiple of the axis size n, split into n chunks:

      1. each rank runs the log-depth suffix scan over its chunk;
      2. one all_gather over `axis` exchanges the n chunk totals (the five
         element tensors flattened into one buffer of 3 n_x^2 + 2 n_x
         floats), whatever H is;
      3. each rank combines the suffix of the later chunks into its own.

    Returns (P (H+1, n, n), eta (H+1, n)), equal to lqt_backward_parallel's
    up to float rounding.  gather_output=True gathers the chunks (an
    all_gather of H-proportional size); False returns this rank's chunk
    of the padded result (ceil((H+1)/n) entries; entries past H+1 are
    identity padding)."""
    h, n = f_mat.shape[0], f_mat.shape[1]
    n_dev = mesh_mod.axis_size(mesh, axis)
    i_dev = mesh_mod.axis_index(mesh, axis)
    elems = _lqt_elements(f_mat, l_mat, c_vec, q_mat, q_vec, r_mat, r_vec,
                          m_mat, p_term, p_vec_term)
    total = h + 1
    pad = (-total) % n_dev
    if pad:
        # Identity padding after the terminal element leaves every suffix
        # that includes it unchanged.
        ident = _identity_elements(pad, n, f_mat.dtype, f_mat.device)
        elems = tuple(torch.cat([e, i]) for e, i in zip(elems, ident))
    chunk = (total + pad) // n_dev
    local = _suffix_scan(tuple(e[i_dev * chunk:(i_dev + 1) * chunk]
                               for e in elems))
    firsts = tuple(e[0] for e in local)
    totals = _unflat(mesh_mod.all_gather(_flat(firsts), mesh, axis), firsts)
    # R_j = T_j (+) ... (+) T_last; this chunk's tail is R_{i+1}, the
    # identity for the last chunk.
    tails = tuple(torch.cat([t, i]) for t, i in zip(
        _suffix_scan(totals),
        _identity_elements(1, n, f_mat.dtype, f_mat.device)))
    _, _, _, eta, j = _combine(local, tuple(
        t[i_dev + 1].expand_as(e) for t, e in zip(tails, local)))
    if not gather_output:
        return j, eta
    whole = _unflat(mesh_mod.all_gather(_flat((j, eta)), mesh, axis),
                    (j, eta))
    return (whole[0].reshape(-1, n, n)[:total],
            whole[1].reshape(-1, n)[:total])


def lqt_gains(f_mat, l_mat, c_vec, r_mat, r_vec, m_mat, p_next, eta_next):
    """Feedback/feedforward gains of the general LQT from the next-step
    value function (P_{k+1}, eta_{k+1}): u_k = -K x_k - k_k.

        quu = R + L'P+L
        K   = quu^{-1} (M + L'P+F)
        k   = quu^{-1} (r + L'(P+c - eta+))
    """
    lt = _t(l_mat)
    quu = r_mat + lt @ p_next @ l_mat
    k_fb = _solve(quu, m_mat + lt @ p_next @ f_mat)
    rhs = r_vec[..., None] + lt @ (p_next @ c_vec[..., None]
                                   - eta_next[..., None])
    k_ff = _solve(quu, rhs)[..., 0]
    return k_fb, k_ff


def lqr_solve_parallel(f_mat, l_mat, c_vec, x_cost, u_cost, x_terminal,
                       x0):
    """Full parallel LQR solve: returns (xs (H+1, n), us (H, m)).

    The backward pass is the log-depth scan plus one batched gains solve;
    the final rollout is the only sequential part."""
    p_all, eta_all = lqr_backward_parallel(f_mat, l_mat, c_vec, x_cost,
                                           u_cost, x_terminal)
    k_fb, k_ff = lqr_gains_from_value(f_mat, l_mat, c_vec, u_cost,
                                      p_all[1:], eta_all[1:])
    xs, us = [x0], []
    x = x0
    for t in range(f_mat.shape[0]):
        u = -(k_fb[t] @ x) - k_ff[t]
        x = f_mat[t] @ x + l_mat[t] @ u + c_vec[t]
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)
