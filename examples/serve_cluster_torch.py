"""End-to-end serving on the PyTorch port: expert engines (reduced
configs of three assigned architectures) + iteration-level continuous
batching + latency calibration + request routing, measured on wall clock
(the port's counterpart of ``examples/serve_cluster.py``).

    PYTHONPATH=src python examples/serve_cluster_torch.py --requests 24
    PYTHONPATH=src python examples/serve_cluster_torch.py --device cpu

It runs on the CUDA card unless ``--device cpu`` asks for the CPU.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--rate", type=float, default=25.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    servers = serve.build_cluster(serve.DEFAULT_EXPERTS, device=args.device)
    fits = serve.profile_cluster(servers)
    for srv, fit in zip(servers, fits):
        print(f"[cluster] {srv.name}: k1={fit['k1']*1e3:.3f} ms/tok "
              f"k2={fit['k2']*1e6:.1f} us/queued-tok")
    out = {"fits": fits}
    for router in ("rr", "sqf"):
        m = serve.run_stream(servers, n_requests=args.requests,
                             rate=args.rate, router=router)
        print(f"[cluster] router={router:4s} -> QoS={m['avg_qos']:.4f} "
              f"lat/tok={m['avg_latency_per_token_ms']:.2f}ms "
              f"p95={m['p95_latency_per_token_ms']:.2f}ms "
              f"done={m['completed']}")
        out[router] = m
    return out


if __name__ == "__main__":
    main()
