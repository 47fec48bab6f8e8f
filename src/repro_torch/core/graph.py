"""Communication graphs and mixing (consensus weight) matrices.

The paper assumes a strongly connected directed graph G = (V, E); its
experiments use fully connected networks with the optimal symmetric weights of
Xiao & Boyd [10].  We implement:

* topologies: complete, directed ring, bidirectional ring, 2-D torus,
  hypercube, star, Erdos–Renyi-conditioned-on-strong-connectivity;
* weights:   uniform in-neighbor averaging (the paper's Algorithm 1 line),
             Metropolis–Hastings weights, and the Xiao–Boyd spectral-optimal
             symmetric weights (closed form via eigenvalues of the Laplacian);
* analysis:  strong-connectivity check, consensus contraction factor sigma
             (second-largest singular/eigen value modulus).

Everything here is small-N numpy; the resulting W matrices are handed to the
consensus step (``core.consensus.mix_stacked``) as host constants.  This is a
copy of the JAX package's ``repro.core.graph``, kept so the port never
imports that package.
"""
from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------- topologies

def complete(n: int) -> np.ndarray:
    A = np.ones((n, n)) - np.eye(n)
    return A


def ring(n: int, directed: bool = True) -> np.ndarray:
    A = np.zeros((n, n))
    for i in range(n):
        A[(i + 1) % n, i] = 1.0          # edge i -> i+1 (column=src, row=dst)
        if not directed:
            A[(i - 1) % n, i] = 1.0
    return A


def torus2d(rows: int, cols: int) -> np.ndarray:
    n = rows * cols
    A = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for j in ((r + 1) % rows * cols + c, ((r - 1) % rows) * cols + c,
                      r * cols + (c + 1) % cols, r * cols + (c - 1) % cols):
                A[j, i] = 1.0
    return A


def hypercube(dim: int) -> np.ndarray:
    n = 1 << dim
    A = np.zeros((n, n))
    for i in range(n):
        for b in range(dim):
            A[i ^ (1 << b), i] = 1.0
    return A


def star(n: int) -> np.ndarray:
    A = np.zeros((n, n))
    A[0, 1:] = 1.0
    A[1:, 0] = 1.0
    return A


def random_strongly_connected(n: int, p: float, seed: int = 0) -> np.ndarray:
    """Erdos–Renyi digraph + a directed ring overlay (guarantees strong conn)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((n, n)) < p).astype(np.float64)
    np.fill_diagonal(A, 0.0)
    A = np.maximum(A, ring(n, directed=True))
    return A


def is_strongly_connected(A: np.ndarray) -> bool:
    n = A.shape[0]
    R = np.eye(n, dtype=bool) | (A.T > 0)        # reachability over out-edges
    for _ in range(int(np.ceil(np.log2(max(n, 2))))):
        R = R | (R @ R)
    return bool(R.all())


# -------------------------------------------------------------------- weights

def uniform_weights(A: np.ndarray, self_loop: bool = True) -> np.ndarray:
    """The paper's Algorithm-1 consensus: x_i <- mean over in-neighbors.

    Row-stochastic.  ``self_loop`` includes the agent's own state in the
    average (needed for convergence on sparse graphs; on complete graphs the
    paper's plain in-neighbor mean is recovered with self_loop=False).
    """
    W = (A > 0).astype(np.float64)
    if self_loop:
        W = W + np.eye(A.shape[0])
    return W / W.sum(axis=1, keepdims=True)


def metropolis_weights(A: np.ndarray) -> np.ndarray:
    """Symmetric Metropolis–Hastings weights (doubly stochastic) for
    undirected graphs (A must be symmetric)."""
    A = ((A > 0) | (A.T > 0)).astype(np.float64)
    np.fill_diagonal(A, 0.0)
    deg = A.sum(axis=1)
    n = A.shape[0]
    W = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if A[i, j]:
                W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(W, 1.0 - W.sum(axis=1))
    return W


def xiao_boyd_weights(A: np.ndarray) -> np.ndarray:
    """Best-constant-edge-weight matrix of Xiao & Boyd (2004), eq. (4.1):
    W = I - (2 / (lam_1(L) + lam_{n-1}(L))) * L  for the undirected Laplacian.

    This is the 'optimal communication weights as defined in [10]' used by the
    paper's experiments (exactly optimal on edge-transitive graphs, e.g. the
    complete graph, where it gives W = (1/n) 11^T).
    """
    A = ((A > 0) | (A.T > 0)).astype(np.float64)
    np.fill_diagonal(A, 0.0)
    L = np.diag(A.sum(axis=1)) - A
    lam = np.sort(np.linalg.eigvalsh(L))
    lam_max, lam_2 = lam[-1], lam[1]
    if lam_2 <= 1e-12:
        raise ValueError("graph is disconnected; Xiao-Boyd weights undefined")
    alpha = 2.0 / (lam_max + lam_2)
    return np.eye(A.shape[0]) - alpha * L


def sigma(W: np.ndarray) -> float:
    """Consensus contraction factor: second-largest eigenvalue modulus of W
    (the rate at which disagreement shrinks, Olfati-Saber & Murray [9])."""
    ev = np.sort(np.abs(np.linalg.eigvals(W)))
    return float(ev[-2]) if len(ev) > 1 else 0.0


def dobrushin(W: np.ndarray) -> float:
    """Dobrushin ergodicity coefficient tau(W) = 1/2 max_{i,j} ||W_i - W_j||_1.

    For row-stochastic W, span(Wx) <= tau(W) * span(x); tau < 1 iff W is
    *scrambling* (every pair of rows shares a positive column).  Unlike
    ``sigma`` it certifies one-shot contraction for products of time-varying
    matrices that share no common stationary vector — the right notion for
    fault-masked mixing sequences."""
    W = np.asarray(W, np.float64)
    diffs = np.abs(W[:, None, :] - W[None, :, :]).sum(axis=-1)
    return float(diffs.max() / 2.0)


# ------------------------------------------------- time-varying sequences

def window_product(W_seq: np.ndarray, start: int, length: int) -> np.ndarray:
    """Backward product W_{start+length-1} @ ... @ W_{start} — the map one
    window of time-varying mixing applies to the stacked agent states."""
    P = np.eye(W_seq.shape[1])
    for t in range(start, start + length):
        P = W_seq[t] @ P
    return P


def windowed_sigma(W_seq: np.ndarray, B: int) -> np.ndarray:
    """Dobrushin contraction factor of every length-B window product of a
    (K, A, A) mixing sequence.  Values < 1 certify that per-agent
    disagreement (span) strictly shrinks across the window."""
    K = W_seq.shape[0]
    if not (1 <= B <= K):
        raise ValueError(f"window B={B} out of range for K={K} steps")
    return np.asarray([dobrushin(window_product(W_seq, t, B))
                       for t in range(K - B + 1)])


def is_b_strongly_connected(W_seq: np.ndarray, B: int,
                            tol: float = 1e-12) -> bool:
    """Check the time-varying form of the paper's connectivity assumption:
    every length-B window of the sequence must jointly restore strong
    connectivity, i.e. the union graph of each window's supports is strongly
    connected.  (With positive self-weights this is equivalent to the
    window *product* having strongly connected support.)  A schedule that
    passes keeps Thm 2.1-style contraction available at the window scale —
    ``windowed_sigma(W_seq, B * (A - 1)) < 1`` — however many individual
    steps are degraded."""
    K, n = W_seq.shape[0], W_seq.shape[1]
    if not (1 <= B <= K):
        raise ValueError(f"window B={B} out of range for K={K} steps")
    for t in range(K - B + 1):
        union = (np.abs(W_seq[t:t + B]) > tol).any(axis=0)
        if not is_strongly_connected(union.astype(np.float64)):
            return False
    return True


def hierarchical_weights(W_pod: np.ndarray, W_intra: np.ndarray) -> np.ndarray:
    """Kronecker two-level mixing  W = W_pod (x) W_intra  — the multi-pod
    agent graph (pods over DCN, replicas inside a pod over ICI)."""
    return np.kron(W_pod, W_intra)
