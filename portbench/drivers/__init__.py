"""Traffic drivers: one module a request kind, named by a mix's `op`.

A mix file (portbench/traffic/<mix>.json) holds the numbers; its driver
holds the code that every mix of that kind shares:

  pool(mix)                         distinct inputs the requests cycle
                                    through
  make_inputs(rng, cfg, mix)        the benchmark's inputs, from the seed
  program(env, inputs) -> request   the port's set-up; request(i) runs
                                    request i and returns its output
                                    without waiting for the device
  reference(ref, cfg, mix, inputs) -> answer
                                    the plain reference's set-up; answer(k)
                                    is its answer for pool entry k, in the
                                    flat layout of `reference.ckks`
  work(cfg, mix) -> counts.Work     one request's least work

Request i runs pool entry i mod pool(mix), so the reference computes each
distinct answer once.
"""
