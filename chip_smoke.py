"""Drive tendermint_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Card and build: the card's name and power limit, the torch and CUDA
   versions, the nvcc builds of every kernel source and of the rate
   probe, all started together (seconds; registers, stack frame and
   spills per kernel). Then the bound's yardstick: the IMAD.WIDE count of
   one field multiplication and one squaring in the SASS (cuobjdump), the
   limb products per lane that gives for B1, B2 and dsm, each kernel's
   longest loop (one ladder step) counted on its own, and the measured
   rates of a saturating IMAD.WIDE and a 32-bit IMAD microkernel.
2. Kernel vs plain version on the card: 4096 lanes mixing valid,
   tampered, malformed and repeated-key signatures, then the main path's
   own lane counts (100, 4 x 1000, 10,000), then the ragged lane counts
   1, 7, 9, 33, 100 and 1025 (a partial last warp and block): the
   kernel's verdicts must equal `verify_plain`'s lane for lane, and a
   256-lane sample must equal `crypto.ed25519.verify`.
3. Main path: commits through `ValidatorSet` and `Verifier` on the card —
   a 100-validator `verify_commit`, fast sync's grouped dispatch of four
   1000-validator commits (`verify_commits_async`), one 10,000-validator
   `verify_commit`, a forged commit and a sub-quorum commit, which must
   both be refused. The kernels' launch counts are reset just before and
   read just after: B1 launches once per batch, B2 and dsm never, and no
   lane may fall to the CPU.
4. Times (CUDA events, median of 7 after a warm-up): the kernel at 100,
   1024, 4096, 10,000 and 16,384 lanes, `verify_plain` at 4096, the
   native CPU batch verifier on a fixed 512-signature sample (best of
   3), and the commit
   phases' wall times. Each line carries the card's name and power limit.
5. B2 (`ed25519_pallas`, the single-bit ladder, four threads a lane) on
   the card: its verdicts equal its plain version's on the 4096 mixed
   lanes, B1's on every shape of phase 2, both at the ragged lane counts
   1, 7, 9, 33, 100 and 1025, and `crypto.ed25519.verify` on a 256-lane
   sample.
6. The dsm kernel (`ed25519.dsm_batch`) on the card: 1025 lanes (the
   last 32-lane block partial) of random scalars and key points with the
   edge lanes (Q = identity, a = 0, b = 0, P == Q, P == -Q) and the real
   terms of a 100-validator aggregate commit equal `dsm_plain`'s bytes
   exactly, and so do their first 1, 7, 9, 33 and 100 lanes; 64 lanes
   equal the pure-Python group law.
7. The main path through B2: the phase-3 commits through a
   `Verifier` built under TENDERMINT_TPU_KERNEL=pallas. B2's launch count
   must equal the device batches; B1's must stay 0.
8. The aggregate path: 100- and 400-validator `AggregateCommit`s (the JAX
   package's upgrade bench sizes) through `ValidatorSet.verify_commit` and
   `verify_commits_async`, which reach `default_verifier()` on the card,
   and a forged, a dropped-signer and a sub-quorum aggregate, which must be
   refused. Every lane must run on the card. After the counts are read,
   the dsm kernel is held against `dsm_plain` on the exact terms of both
   aggregates (101 and 401 lanes), bytes exactly.
9. Times: B2 and dsm against their bounds, their plain versions, the
   aggregate verify split into host and device stages, and the B2 path's
   commit wall times.
10. B1' (`ed25519_f32p.ShardedVerify`: B1 launched once per shard,
   each shard on its own device and stream) on two meshes, every visible
   card and 4 shards over cuda:0: on the 4099-lane quorum batch of
   `multichip.quorum_batch` and on every lane set of phase 2 (the 4096
   mixed lanes, the 100- and 10,000-validator commits and the 4 x 1000
   group, which give phase 11's shard geometries), its verdicts equal
   the unsharded kernel's and `verify_plain`'s lane for lane, the forged
   lanes are exactly (0, 1777, 4096, 4098), and the layout has one entry
   per shard with equal lanes. Then `multichip.dryrun_multichip` over
   every visible card.
11. The sharded main path: a `ShardedVerifier` on 4 shards over cuda:0
   verifies the 10,000-validator commit, the 4 x 1000 fast-sync group,
   the refused forged and sub-quorum commits, a primed 100-validator batch
   (`prime_cache_async` / `verify_one`) and a 100-validator commit whose
   set mixes 96 ed25519 and 4 secp256k1 keys, made with the port's
   `VoteSet`. B1 launches 4 times a device batch, B2 and dsm never, and
   exactly the secp256k1 lanes run on the CPU.
12. Times: the mesh's own window on the card (one start event, every
   shard stream waiting on it, the current stream waiting on every
   shard's end) at 4096 and 16,384 lanes on 1 and on 4 shards over
   cuda:0, the host's time to issue one launch, the 10,000-validator
   commit through `Verifier` and through `ShardedVerifier` on 1 and 4
   shards, and the sharded dispatch of its lanes stage by stage.

13. The comb kernels (`ed25519_comb`: B4's verify against per-key tables;
   `ed25519_comb_tables`: the table build) against their plain versions on
   the card: the tables of 1, 7, 33, 64, 65 and 1000 keys, bytes exactly;
   every table of the 10,000-validator set built in one launch, bytes
   exactly too, and 8 sampled keys' rows equal to a pure-Python niels
   table; the comb verdicts on every lane set of
   phase 2 and at the ragged lane counts equal `verify_comb_plain`'s raw
   verdicts and B1's masked ones.
14. The main path through comb: the phase-3 commits under
   TENDERMINT_TPU_KERNEL=comb, each twice, after `reset_default_pool()`,
   then the forged and sub-quorum commits. Every pass's B1, comb and
   table-build launches must be the second-sight policy's: a lane whose
   key is seen for the first time rides B1, a key's second sight builds
   its table (one launch a pass), and every second pass runs on comb
   alone; one table a distinct key.
15. A 64-slot pool on the card: eviction, a batch of more keys than the
   pool holds (PoolExhausted: the lanes ride B1), and a rebuild of evicted
   keys, every verdict right.
16. The torch compositions: the 100-validator commit under
   TENDERMINT_TPU_KERNEL=f32 (B3) and int32 (B5's verify), and through a
   4-shard f32 `ShardedVerifier`, with no kernel launched; int32's
   `decompress_batch` and both verifies on the card equal to the CPU and
   the reference.
17. Times: the comb kernel at 100 to 16,384 lanes of commit signatures,
   the table build at 1, 100, 1000 and 10,000 keys, their plain versions,
   the comb path's commit wall times, and f32 and int32 per batch.

18. The hash kernels against their plain versions on the card: K1
   (RIPEMD-160) and K2 (SHA-256), `csrc/hash_blocks.cu`, at 1, 7, 33, 100
   and 1,025 messages whose first lanes have the lengths 0, 55, 56, 63, 64,
   119, 120, 10,240 and 65,536, digest words equal to the plain version's
   (run once over the widest batch's messages of at most 33 blocks) and,
   every lane, to crypto.hashing.ripemd160 / hashlib.sha256; K3 (the Merkle tree), `csrc/merkle_tree.cu`,
   at 2 to 10,000 leaves, every node equal to `_run_tree` and to
   FlatTree.from_leaf_digests, slot for slot.
19. The main path of the hash plane: `Block.make_block` wired as
   consensus wires its Hasher (`set_batch_tx_root(h.tx_merkle_root)`, the
   part hashers and the tree submitter), with a fresh `Hasher()` on the
   card, for `block_1mb` (BASELINE.json's 1 MB block of 64 KB parts: 4,000
   transactions of 250 bytes) and `block_cap` (types/params.py's caps:
   10,000 transactions of 1 to 4,096 bytes, every 1,000th at 10,240; about
   21 MB, 318 parts), the phase-3 100-validator commit as last commit.
   Launches reset before and read after each build (K1 2, K3 2, nothing
   else), `stats()` (one part batch, one tx root, no CPU leaf, one
   submitted job), the block equal to the same block built under
   TENDERMINT_TPU_HASHES=0 (bytes, header, data hash, part-set header,
   every proof), `Block.from_bytes` of its bytes hashing the same, a
   PartSet from its header accepting every part, and a flipped byte
   refused. Then K2's path, `ops.hashing.sha256_batch`, once. Every
   kernel call of these paths is recorded (its inputs and output), and
   after the counts are read each is held against its plain version on
   the card: K1's lanes of at most 33 blocks (both blocks' tx leaves, most
   of them) and K2's in one plain walk each, every longer lane (the 64 KB
   parts, the longer transactions) against the host's digest of the
   message read back from the recorded words; K3 on the four real trees
   (16, 318, 4,000 and 10,000 leaves).
20. Times: the ALU yardsticks (`imad_rate.cu`'s LOP3/IADD3/SHF rate and
   one dependent instruction's latency), K1 on both blocks' part and
   tx-leaf batches, K2 on the tx leaves, K3 on phase 19's four trees
   (CUDA events around a call, and the kernel's device time from the
   profiler), each with its bound (`hash_bound`) and the native host
   library's time on the same input, the plain versions where a run is
   short (their results held against the kernel's too), and
   `make_block`'s wall time through the card and the host floor with
   where a card build's time goes.

21. The device daemon: `python3 -m tendermint_tpu_torch.devd` on the
   card (a socket in a short directory under /tmp, SIGTERM honoured,
   TENDERMINT_DEVD_KERNEL unset so its claim-time bake-off of comb against
   B1 runs), serving within DEVD_HELD_S; with TENDERMINT_DEVD_SOCK set and
   TENDERMINT_TPU_KERNEL unset, `kernel_name()` must answer "devd", and a
   default `Verifier` and `Hasher` route through it. The phase-3 commits
   through it (the forged and sub-quorum ones refused), their lanes and a
   10,000-lane verify_stream lane for lane equal to B1's in process,
   `agg_100`'s terms through the agg op equal to the dsm kernel's points,
   block_cap's parts through hash_stream with the tree frame equal to K1's
   and K3's in process, and both blocks built through it equal to the host
   floor. The daemon's counts (read through its `stats` op, before and
   after) must show every lane on the card and none on its CPU, each of
   the path's kernels launched, and the breaker CLOSED throughout; the
   daemon is shut down (killed after DEVD_STOP_S) whatever happens.
22. Times: the daemon's claim and build seconds, its bake-off rates and
   the kernel and chunk width it chose, the `bench` op's sigs/s, each
   path's wall time through the daemon beside the same call in process,
   and hash_stream's MB/s on block_cap's parts.

23. The multi-daemon plane: two daemons on cuda:0, each its own process
   and CUDA context (B1 pinned, a 1,024-lane warm-up, phase 21's chunk
   width), behind TENDERMINT_DEVD_SOCKS, with a default `Verifier` and
   `Hasher` slicing every batch over both (ops/devd_shard.py). The phase-3
   commits (the forged and sub-quorum ones refused), their lanes again,
   `agg_100` and `agg_400` (their commits and their dsm points), a
   10,000-lane `verify_batch_async`, both blocks and block_cap's parts
   through `hash_tree`: every lane, point, digest, node and block byte
   equal to the in-process kernels' and the host floor's. Both endpoints
   serve; the two daemons' `tpu_sigs` grow by exactly the lanes sent and
   their `cpu_sigs` not at all; no lane, leaf or aggregate lane on this
   process's CPU; every breaker CLOSED; each daemon launched B1, dsm and
   K1, and no B2, K2, comb or K3 (the fleet builds a tree's internal nodes
   on the host from the gathered digests). Then chaos: a `FaultProxy` in
   front of endpoint 1 is blacked out while the 10,000-lane batch and the
   block_cap build run, again and again until endpoint 1's breaker opens
   (endpoint 0's stays CLOSED), every result still equal and nothing on
   the CPU; after the blackout traffic re-closes the breaker and endpoint
   1 serves again; `Verifier.stats()` carries the `faults_*` counters; and
   `DaemonSupervisor` refuses a card daemon's environment.
24. Times: warm best of 3 of `commit_large`, `fast_sync_group`, the
   10,000-lane batch, `make_block` at block_cap and the parts' tree through
   the fleet, beside phase 22's one daemon and the same call in process,
   with the fleet's slice plan for each (slices, lanes and steals an
   endpoint); then where a wide path's time through a daemon goes: the
   client's chunk encoding, the daemon's decoding (run here on the same
   bytes), the commit check and the in-process marshal and kernel, and
   what is left (the socket and the daemon's scheduling), for
   `commit_large`, `make_block` at block_cap and the parts' stream.

25. The ABCI application plane, in process (no daemon socket in the
   environment; the default `Verifier` and `Hasher` must take the local
   route on the card): a host-built `SignedKVStoreApp` of APP_STATE_KEYS
   keys (`acct-%07d`, 64-byte values from the seed) snapshots, and a
   fresh app whose state tree hashes through `default_hasher()` restores
   it: its app hash equal to the host's, every wave of 32 or more one K1
   launch, `tpu_leaves` equal to the tree's `gateway_nodes`. Then three
   blocks of 10,000 signed txs (8,000 updates, 1,960 new keys, 30 `rm:`
   deletions, 10 forged signatures), sharded over 4, through
   `AppConns(LocalClientCreator(app))` as state/execution.py drives them
   (begin_block, one `deliver_txs_async` of the block, end_block, commit),
   beside the reference (the same app class, host hashing, a `Verifier`
   whose gate sends every lane to the native CPU floor): responses, logs
   and app hashes equal, exactly the forged txs refused, one B1 launch a
   block (`tpu_sigs` up 10,000, `cpu_sigs` 0), K1 once for the block's
   priorities and once a wide wave at commit, 3 sharded batches; 64
   sampled keys (untouched, updated, deleted, absent) prove against the
   committed root, the card app's proofs equal to the host's byte for
   byte. Then a block of 1,000 through an `ABCIServer` and a
   `SocketClient` to each app (tx by tx: each verifies on the host, the
   commit's waves on K1): responses and app hashes equal.
26. Times, the card against the host reference: the restore (one run;
   its tree build, its hashing and the Hasher's K1 calls within it), the
   three blocks replayed on freshly restored apps, each split into the
   verify (B1 with its marshal, or the native CPU floor), the priorities,
   the fold and the commit (its hashing, the K1 calls, the waves and their
   widths), and K1's device time on the widest wave of a restore and of a
   commit beside hashlib on the same preimages.

27. The execution path, in process (no daemon socket; the default
   `Verifier` and `Hasher` must take the local route on the card): phase
   3's 100 validators in a genesis with `upgrade_height` 3 to aggregate
   commits, wired by hand as node/node.py wires a node in a temp directory
   (sqlite `state`, `blockstore` and `tx_index`, `State.get_state` with a
   `KVTxIndexer`, a `SignedKVStoreApp` on 4 shards behind `AppConns`
   hashing through `default_hasher()`, a `Mempool` with a WAL gated by
   `SigBatcher(default_verifier(), parse_sig_tx)`), beside the same chain
   on the host reference (`host_hasher()`, a `Verifier` whose gate sends
   every lane to the native CPU floor, the default verifier around its
   aggregate height). Three heights: 10,010 signed txs (10 forged)
   through `check_tx`, drained; `reap(10_000)`; the block built as
   consensus builds it (`make_block_with`, the LastCommit full at height 2
   and aggregate at 3); `apply_block` with `commit_batch_verifier()`;
   the height's 100 precommits signed and `save_block`. Exactly the
   forged txs refused at the gate and none of them at the app; block
   bytes, part-set header, state bytes, app hash, deliver responses,
   store records and 64 sampled tx-index entries equal to the
   reference's, and the mempool WALs too; a forged precommit in block 2's
   LastCommit and a dropped signer in block 3's refused. Launches: B1 once
   a gate batch of 32 or more (`tpu_sigs` / `cpu_sigs` from the recorded
   batch sizes), once for block 2's LastCommit and once a deliver; dsm
   once, for block 3's 101-lane aggregate; K1 2 and K3 2 a block built,
   K1 once a wave the app hands its Hasher; the reference none. Then the
   sqlite files reopen to the same state and blocks, and a fresh card
   app replays the stored blocks through `exec_commit_block` to the same
   app hashes.
28. Times of phase 27's card and host chains (each height after a full
   collection of the heap, the two chains in turns): the burst (first
   check_tx to drained, and the gate thread's seconds in the verifier),
   `make_block`, `validate_block`, `apply_block` split into the deliver,
   the app commit and the state save with indexing, and `save_block`.

29. The transport and fast sync, in process (no daemon socket): node A, an
   exec_chain of benches/bench_fastsync.py's 1,000 validators (phase 3's
   1,000-validator set) with `upgrade_height` 6, builds 7 heights of
   1,000 signed txs (960-byte values: blocks over 1 MB, 17 or more 64 KB
   parts) and serves its sqlite store through a BlockchainReactor on a
   switch with a listener on 127.0.0.1. Node B, empty, wired as
   node/node.py wires a node (sqlite stores, a SignedKVStoreApp on 4
   shards behind AppConns, the reactor on `Verifier(device="cuda:0")`'s
   commit_batch_verifier and verify_batch_async and a `Hasher` on the
   card's part hashers, the tx-root hook on that Hasher), dials A over TCP
   with secret connections (5,120,000 B/s each way, a 10 ms flush
   throttle), syncs the 7 heights the pool can prove (the last waits for
   its successor's LastCommit; `BlockPool.is_caught_up` confirms) and
   switches to consensus once. Its blocks, store records, sampled tx-index
   entries, state and app hash equal A's, and so do those of the host
   reference B' (every lane on the native CPU floor, the aggregate
   LastCommits on the host's reference check, host hashing), which
   launches nothing. Launches, set to 0 before B's dial and read after: B1
   once a verify group (each of whole commits, 4 or fewer), once a full
   LastCommit at apply and once a deliver; dsm once an aggregate LastCommit
   proving a height and once one checked at apply (1,001 lanes); K1 and K3
   twice a block (its part set, its tx root), K1 once a commit wave; the
   verifier's `tpu_sigs` and `agg_lanes_device` equal to those lanes, none
   on the CPU. Then a tampered peer C (A's blocks, one signature of block
   13's LastCommit flipped), dialed before A, is stopped for "sent invalid
   block" exactly once, A stays, and the records are A's.
30. Times of phase 29's B and B' (the smoke's clock allows no second
   pair), each on fresh stores after a full collection: the sync's wall
   time (the dial to the last block applied) and blocks/s (`fastsync_blocks_per_sec`), the reactor's `stage_s`
   (dispatch, which holds part_hash, verify_wait, store_save, apply) and
   the wall time they leave (the transport and the pool).
31. The consensus state machine, in process (no daemon socket): a
   400-validator committee (phase 3's first 400 keys, the node's key at
   the largest power of at most a fifth of the total that the rotation
   elects at height 1 and once from the upgrade height 7 on, the rest at
   power 1) drives a `ConsensusState` wired as node/node.py wires one
   (`committee_node`: sqlite stores, the signed kvstore on 4 shards behind
   AppConns with the Handshaker, a gated Mempool with its WAL, the
   consensus WAL, `pipeline_apply`, `Verifier(device="cuda:0")` and the
   card's `Hasher` as the defaults, the tx-root hook on it). The pump
   (`committee_pump`, as benches/bench_committee.py drives its node) feeds
   a height's 1,000 signed txs and 10 forged through check_tx, builds a
   stub proposer's block as the node would, and injects the 399 stubs'
   prevotes and precommits; at height 3 one precommit carries a flipped
   signature. 8 heights, a stop, a new node over the same files
   (Handshaker replay, WAL catchup, the seen commit primed) and 2 more.
   Every height commits at round 0; records and states equal the host
   reference's (the native CPU floor, the host's aggregate check, host
   hashing; in a process of its own beside the card node), which
   launches nothing; only the forged precommit is
   refused. Launches, set to 0 before each session's node is built and
   read after its pump, equal what the chain implies
   (`committee_expected`): B1 once a vote micro-batch, a gate batch, a
   deliver and a full-LastCommit check (four a height: prevote, lock,
   finalize, apply) at or above the size gate, and once for the restart's
   seen commit; dsm four times an aggregate LastCommit; K1 and K3 once a
   tx root and a part set of the node's own proposals, K1 once a wide
   state-tree wave; `tpu_sigs` and `agg_lanes_device` equal the lanes.
32. Times of phase 31's first sessions (the smoke's clock allows no
   second pair), the card node's and the host reference's, each on a
   fresh home: blocks_per_sec, the consensus trace's segments a height, the vote
   plane's batches, signatures, singletons and
   consensus_vote_verify_batch_seconds, the pipeline's join wait and
   overlap, and the pump's signing seconds.
33. The gossip, in process: four port validators V0-V3 of a 100-validator
   chain (phase 3's first 100 keys; GOSSIP_NODE_KEYS at GOSSIP_NODE_POWER,
   35% of the power, the other 96 at power 1; `upgrade_height` 3), each
   wired as node/node.py wires one (`gossip_node`: committee_node with the
   kv tx index, its own `Verifier(device="cuda:0")`, the shared card
   `Hasher`, a MempoolReactor and a ConsensusReactor) on a full mesh of
   switches over TCP with secret connections, and a fifth switch for the
   stubs (`stub_relay`): their prevotes and precommits once every node has
   voted (stubs 0-47 to V0, 48-95 to V1: V2 and V3 hear them by relay),
   a stub proposer's block and parts, one forged precommit at height 3.
   Each height's 1,000 signed txs and 10 forged go through one node's
   check_tx and reach the rest through the mempool reactor. V3 starts
   empty after height 3 and catches up through the consensus reactor
   (precommits one at a time; one screened AggregateCommitMessage a height
   whose stored commit is an aggregate), then votes in 4-5 and proposes
   5. Every node's
   blocks, metas, saved states and tx-index records are equal, and equal
   to a host replay of V0's chain (`gossip_reference`, a process of its
   own); only the forged precommit and the forged txs are refused, at V0
   and at the fed gate alone; no device error, no fail-open, no peer
   stopped. Launches, set to 0 before the first node is built and read
   after the last commit, equal what the chain implies
   (`gossip_expected`), and the lanes the verifiers' stats.
34. Times of phase 33's run: blocks/s over heights 2-5, the pump's steps a
   height, each node's trace segments, vote batches (direct, relayed,
   widths, on the card), duplicate ratio, has-votes and part announces,
   bytes a height, V3's catch-up a height (parts, commit), the host
   replay's seconds.
35. RPC, the light client and state sync (the state_sync cell): node A of
   a 1,000-validator chain (phase 3's first 1,000 keys, `upgrade_height`
   6) whose app holds phase 25's 250,000 keys from genesis (its tree
   loaded before block 1, the genesis app hash their root) builds 9
   heights of fast sync's bursts and snapshots height 7 (64 KiB chunks),
   then serves its files from a process of its own: a StateSyncReactor,
   a BlockchainReactor and an RPCServer (`serve_statesync`); D, a second
   process on the same files, flips one byte of the first chunk it
   serves. Node C, empty and wired as node/node.py wires a restoring node
   (`statesync_node`: a LightClient over HTTPClient to A's RPC on the
   card's batch verifier, a Restorer on the card's Hasher, the
   StateSyncReactor, the BlockchainReactor deferred for the tail), dials
   D then A over TCP with secret connections, light-verifies the manifest
   (the walk to height 8 crosses the upgrade), downloads, restores and
   fast-syncs height 8, then switches to consensus once. C equals A
   (store base and records, seen commit, state, app hash, sampled
   values), and so does the host reference C' (a process of its own
   beside C, served by a second process on A's files), which launches
   nothing; D is stopped once for the flipped
   chunk and A stays; sampled present and absent keys verify through
   `LightClient.verified_query` against A's RPC. Launches, set to 0 just
   before C's dial and read just after, equal `statesync_expected` (B1
   and dsm a full and an aggregate commit of the walk, the seen commit
   and the tail's; K1 the whole-manifest digests, each restore wave and
   the tail's; K3 the tail's), and so do the lanes and the Hasher's
   stats (the 8-chunk windows on the host).
36. Times of phase 35's C and C': the wall from the dial to the switch
   to consensus and its split (discovery, the manifest and the light
   walk with its verify seconds, the download, the chunk checks, the
   restore's tree build and seed, the tail with its blocks/s), the bytes
   received, phase 35's marks (A built, servers ready, C switched, C'
   done), K1's device time on the whole-manifest digest batch, and the
   snapshot's CRC-32C frames on this host (`crc32c_fallback` against the
   byte loop).
37. The node (the node_validator cell): one port `Node`, built by
   `default_new_node` from a home written as an operator's (`node_home`:
   config.toml through the port's config/toml, genesis.json,
   priv_validator.json; the signed kvstore behind the gate, the kv tx
   index, sqlite, RPC and p2p on 127.0.0.1, PEX with its address book, no
   UPnP, a snapshot every 4 heights, no pruning), a validator of a
   100-validator chain (phase 3's first 100 keys at power 1, the node at
   `committee_power`'s 24; `upgrade_height` 3) on the gateway's defaults
   (the card's Verifier and Hasher). `committee_pump` drives it through a
   thin adapter (`node_adapter`: its consensus state, genesis, priv
   validator; each burst sent over the node's own HTTP JSON-RPC
   `broadcast_tx_sync` by 64 client threads on keep-alive connections)
   with the other 99 keys as stubs: heights 1-6 of 1,000 signed txs and
   10 forged, a forged stub precommit at 6; the node stops and a second
   Node from the same home (the Handshaker's replay, the WAL, the seen
   commit primed) commits 7-8. A host replay of the node's stored chain
   (`gossip_reference`, a process of its own beside the card) holds
   every saved state, app hash and tx-index sample the node's; every
   valid tx is in exactly one block, every forged one refused at the
   gate; only the forged precommit refused; /status, /health, /block and
   /commit of each height, GET /metrics' gateway counters against
   `stats()` (above 0 on the card), a sampled tx's /tx_trace. Each
   session's launches, set to 0 before its node is built and read after
   its pump and snapshots, equal `node_expected` (B1 the full LastCommit
   checks at 2, the delivers, the replay, the seen commit, the gate's and
   vote plane's batches as recorded; dsm four aggregate checks a height
   from 3; K1 and K3 the tx roots and own part sets, K1 the tree waves and
   the snapshot's chunk digests at 4 and 8).
38. Times of phase 37, read through the node's RPC and `stats()`: each
   height's wall and /consensus_trace segments, the RPC ingest rate of
   each burst, the gate's batches and the share of gate lanes on the host
   floor, the restart's build (handshake) seconds, the host replay's
   seconds.
39. The localnet (the localnet cell): the port's `ops/localnet` generates
   a fleet of 4 validators at equal power (the signed kvstore behind the
   gate, sqlite, a full mesh through netfaults link proxies, aggregate
   commits from height 3, generous propose and vote timeouts, a 10 s commit
   window) and starts it: four `python -m tendermint_tpu_torch.cli node`
   processes, each holding the card (no daemon, no host fallback in their
   environment). Each of 4 bursts of 1,000 signed txs and 10 forged goes
   to node 0 over its HTTP JSON-RPC `broadcast_tx_sync` from 64 client
   threads in the window before a proposal: the first once every member's
   RPC answers (height 1's start window), each next one once the height
   before it commits. Every height is byte-identical on the four
   (`Localnet.assert_converged`); each valid tx is in exactly one block
   and no other tx is, the forged ones refused at the gate (the heights
   that hold each burst, and their rounds, are logged). Each process's
   kernel launches, counted from 0 in it and printed by its CLI as it
   stops (`kernel launches {...}`), are held in `localnet_expected`
   against its gateway counters, read through `ops/fleet`'s scrape of its
   GET /metrics just before the stop, and against the chain: B1 a launch
   a device batch (a deliver a burst block, and the gate's batches of 32
   or more, node 0's among them: these the scrape bounds, 32-512 lanes a
   batch and no more lanes than the gate saw, but nothing predicts); no
   dsm (a 4-validator commit stays under the gate on the host); K1 and K3
   a tx root and an own part set, K1 a tree wave as the host replay's,
   each counted from the chain; the replica none.
   A `python -m tendermint_tpu_torch.cli replica` process follows node 0 and
   serves 8 present and 8 absent keys at the last burst height, through a
   `LightClient` pointed at it, equal to node 0's values. SIGTERM ends
   every process with exit 0; a host replay of node 0's stored chain
   (`gossip_reference`, a process of its own) gives its saved state and
   every app hash; `cli --home <node 0> replay` exits 0 having replayed
   node 0's WAL to its height. The launches are the members'; this
   process launches nothing.
40. Times of phase 39: each member's spawn to its RPC and to its first
   height, and where a port process's start goes (`startup_probe`, a fresh
   process: the torch import, the package, the CUDA context, the
   libraries' load, B1's first and second launch); each burst height's wall
   and `/consensus_trace` segments on every member; the RPC ingest rate of
   each burst; the replica's walk and a verified read through it; the
   replay's and the host replay's seconds.
41. The kernels line, with each kernel's launches on every path beside
   its entry (`localnet_launches`: the sum of the five processes' logged
   counts).

Each phase's start is logged on a line of its own, in seconds since
launch. Each path's launch counts are set to 0 just before it and read just after
(the daemons', in phases 21 and 23, read from their logs before and after;
the localnet's processes', in phase 39, from the line each prints as it
stops, their counts starting at 0 with each process).
The last lines are the kernels' JSON summary, the card line, and
{"ok": true, "device": {...}}. Weights are keys made from a numpy seed;
no network, one card.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

SEED = 20261016
CHAIN_ID = "chip-smoke"
DEVICE = "cuda"
SET_SIZES = (100, 1000, 10_000)  # BASELINE.json: VerifyCommit, fast sync, north star
AGG_SIZES = (100, 400)  # BENCH_r22.json rows wire:n=100, wire:n=400
MIXED_LANES = 4096
DSM_LANES = 1025  # not a multiple of the 32-lane block: the last block is partial
DSM_TIME_LANES = (101, 401, DSM_LANES, 4096)
# lane counts that end in a partial warp (8 lanes) and a partial block (32)
RAGGED_LANES = (1, 7, 9, 33, 100, 1025)
TIME_LANES = (100, 1024, 4096, 10_000, 16_384)
# The limb products' rate: IMAD.WIDE (signed 32x32->64 with a 64-bit
# addend, one per limb product in the SASS), the plateau of phase 1's
# probe swept over chains and blocks an SM, whose loop holds IMAD.WIDE and
# nothing else but its counter and branch, on an H100 80GB HBM3 at 700 W:
# 8.35e12/s, half the 32-bit IMAD rate there (16.63e12/s; NVIDIA's 67
# TFLOP/s fp32 / 2 / 2 = 16.75e12): a wide product takes two multiply
# slots. Phase 1 logs this run's sweep beside it.
INT_MUL_PER_S = 8.35e12
HBM_BYTES_PER_S = 3.35e12
CSRC = "tendermint_tpu_torch/ops/csrc/"
KERNEL_NAMES = ("ed25519_verify", "ed25519_verify_b2", "ed25519_dsm")
COMB_NAMES = ("ed25519_comb", "ed25519_comb_tables")  # phases 13-17
COMB_TABLE_KEYS = (1, 100, 1000, 10_000)  # table builds timed in phase 17
COMB_JSON_KEYS = 100  # the table build of the kernels line: the 100-validator commit's
COMB_RAGGED_KEYS = (1, 7, 33, 64, 65, 1000)  # table builds held against the plain version in phase 13
COMB_PLAIN_CHUNK = 2500  # keys a plain build of phase 13's 10,000-key check
SMALL_POOL = 64  # phase 15's pool: 63 usable slots
# int32 decompress_plain's work a key, counted from its code (19
# multiplications, 255 squarings), in radix-2^25.5 limb products: the
# least time of a decompression on the card (phase 16)
DECOMPRESS_PRODUCTS_PER_KEY = 100 * 19 + 55 * 255
# phase 15's batches, lane ranges of the 100-validator commit: 40 keys; 50
# keys of which 40 new (so at least 40 - (63 - 40) = 17 evictions); all 100
# (more than the pool holds); 10 keys evicted by the second batch
SMALL_POOL_BATCHES = ((0, 40), (30, 80), (0, 100), (0, 10))
PROBE = "imad_rate"  # the multiply-rate probe of phase 1, not a kernel of any path
# the TPU (or XLA) kernel each one replaces, by file:line of its body
REPLACES = {
    "ed25519_verify": "tendermint_tpu/ops/ed25519_f32p.py:301",
    "ed25519_verify_b2": "tendermint_tpu/ops/ed25519_pallas.py:186",
    "ed25519_dsm": "tendermint_tpu/ops/ed25519.py:542",
    "ed25519_comb": "tendermint_tpu/ops/ed25519_comb.py:151",
    "ed25519_comb_tables": "tendermint_tpu/ops/ed25519_comb.py:208",
    # B1' is B1's kernel launched per shard: its pallas_call under shard_map
    "ed25519_verify_sharded": "tendermint_tpu/ops/ed25519_f32p.py:468",
    # B6, XLA: the hash kernels (K1, K2) and the tree rounds (K3)
    "ripemd160": "tendermint_tpu/ops/hashing.py:133",
    "sha256": "tendermint_tpu/ops/hashing.py:232",
    "merkle_tree": "tendermint_tpu/ops/merkle.py:126",
}
# phases 18-20: the hash plane (B6)
HASH_NAMES = ("hash_blocks", "merkle_tree")  # K1 and K2 share a source; K3
HASH_COUNTS = (1, 7, 33, 100, 1025)  # messages a K1 / K2 batch in phase 18
# where the block count changes (55/56, 119/120), the empty message, the
# tx cap and a 64 KB part: the first lanes of every phase-18 batch
HASH_EDGE_LENGTHS = (0, 55, 56, 63, 64, 119, 120, 10_240, 65_536)
# the longest message the plain K1 / K2 walks take (phases 18-19): the
# walk's time grows with the longest message's blocks (a 65,536-byte
# part's 1,025 took 35-40 s); a longer message is held against the host's
# digest of it instead
PLAIN_MAX_BLOCKS = 33
# K3 against its plain version in phase 18; 336 is the part count of a
# block at the byte cap (22,020,096 / 65,536); around K3's cut (a round
# wider than one block's sweep of 512 nodes runs on a grid): 1,024 and
# 1,536 leaves, whose widest round is 512 (one block), 1,537 (513: the
# smallest tree on a grid) and 4,000 (two rounds on a grid)
TREE_LEAVES = (2, 3, 5, 7, 16, 33, 100, 336, 1024, 1536, 1537, 4000, 10_000)
# the kernels line's shapes: block_1mb's tx leaves (K1, K2) and part tree (K3)
HASH_JSON_BATCH, TREE_JSON_BATCH = ("block_1mb", "tx_leaves"), ("block_1mb", "part_tree")
# BASELINE.json's "PartSet Merkle-root + SimpleProof verify, 1MB block / 64KB
# parts": 4,000 transactions of 250 bytes
BLOCK_1MB_TXS, BLOCK_1MB_TX_BYTES = 4000, 250
BLOCK_TIME_NS = 1_760_000_000_000_000_000
APP_HASH = b"\x5a" * 20
# the hash kernels' instructions in the SASS, by opcode (LEA.HI and VIADD
# carry RIPEMD-160's rotate-and-add and its constants)
ALU_OPS = ("LOP3", "IADD3", "SHF", "LEA", "VIADD", "LDG", "STG")
# a RIPEMD-160 line's round constants as SASS immediates: the innermost
# loop that holds one runs that line (K1 and K3 run each line on a warp of
# its own, in a loop of its own or behind a branch on the warp)
RMD_LINE_MARKS = {"left": r"0x(5a827999|6ed9eba1|8f1bbcdc|a953fd4e)\b",
                  "right": r"0x(50a28be6|5c4dd124|6d703ef3|7a6d76e9)\b"}
# K2's two warps' loops by their rotates (SHF.L.W / SHF.R.W by a distance
# or its complement to 32): only the rounds' Sigma0 / Sigma1 rotate by 2,
# 6, 11 or 22, only the schedule's sigma0 / sigma1 by 17 or 18
SHA_WARP_MARKS = {"compression": r"SHF\.[LR]\.W\S* [^;]*, 0x(2|1e|6|1a|b|15|16|a)\b",
                  "schedule": r"SHF\.[LR]\.W\S* [^;]*, 0x(11|f|12|e)\b"}
SHARDS = 4  # B1' on one card: 4 shards over cuda:0
PROFILE_TRIES = 3  # traces device_ms takes before it gives up on a kernel
# a plain version's time: one run on the card (each was run on the card by an
# earlier phase's check; a run of B1's or B2's takes 3-7 s)
PLAIN_TIME_REPS = 1
MIXED_SECP = 4  # secp256k1 validators of the 100-validator mixed commit
DEVD_HELD_S = 180  # phase 21: the daemon's start, probe, build, warm-up and bake-off
DEVD_STOP_S = 30  # the daemon's exit after the shutdown op, before it is killed
FLEET = 2  # phase 23: daemons on cuda:0 behind TENDERMINT_DEVD_SOCKS
FLEET_WARM = "1024"  # their warm-up shape (phase 21 ran the bake-off)
FLEET_BLACKOUT_S = 3.0  # phase 23: endpoint 1 dark behind its FaultProxy
FLEET_WAIT_S = 60.0  # the bound on endpoint 1's breaker opening, and re-closing
# phases 25-26, the app_block cell: the state (5x the 50,000 keys of the JAX
# package's statetree bench, BENCH_r13.json commit-vs-rebuild), and a block at
# types/params.py's max_txs of 10,000 signed kv txs
APP_STATE_KEYS = 250_000
APP_VALUE_BYTES = 64
APP_BLOCK = (("update", 8_000), ("new", 1_960), ("delete", 30), ("forged", 10))
APP_SOCKET_BLOCK = (("update", 800), ("new", 190), ("delete", 8), ("forged", 2))
APP_HEIGHTS = 3
APP_SHARDS = 4  # the kvstore's keyspace shards (TENDERMINT_KVSTORE_SHARDS)
APP_SIGNERS = 64
APP_PROOF_KEYS = 16  # sampled keys of each kind: untouched, updated, deleted, absent
APP_REF_GATE = 10_001  # the reference Verifier's size gate: a block's lanes on the native CPU floor
APP_MIN_GATEWAY = 0.96  # a card restore's K1 leaves, at least this share of the state's keys
APP_RESTORE_RUNS = 1  # phase 26: the restore once each, card and host in turns (the clock)
# phase 25's launches beside B1's and K1's entries in the kernels line
APP_LAUNCH_KEYS = {"ed25519_verify": "b1", "ripemd160": "ripemd160"}
# phases 27-28, the exec_chain cell: phase 3's 100-validator set (BASELINE.json's
# VerifyCommit size, the Cosmos Hub's launch max_validators) with an upgrade to
# aggregate commits at height 3 (docs/upgrade.md), and bursts of types/params.py's
# max_txs of 10,000 signed kv txs and 10 forged ones a height
EXEC_HEIGHTS = 3
EXEC_UPGRADE_HEIGHT = 3  # block 2 carries a full LastCommit, block 3 an aggregate one
EXEC_FIRST_BLOCK = (("new", 10_000), ("forged", 10))
EXEC_BLOCK = (("update", 7_000), ("new", 3_000), ("forged", 10))
EXEC_VALUE_BYTES = 64
EXEC_SIGNERS = 64
EXEC_INDEX_SAMPLE = 64  # txs whose tx-index entries are compared each height
EXEC_DRAIN_S = 300.0  # the bound on a burst's drain
# phase 27's launches beside the kernels' entries in the kernels line
EXEC_LAUNCH_KEYS = {"ed25519_verify": "b1", "ed25519_dsm": "dsm", "ripemd160": "ripemd160",
                    "merkle_tree": "merkle_tree"}
# phases 29-30, the fast_sync cell: benches/bench_fastsync.py's 1,000 validators
# (BASELINE.json config 4, fast-sync replay) at equal power, default
# ConsensusParams, an upgrade to aggregate commits at height 6
# (docs/upgrade.md); 7 heights of config 4's 10,000, each 1,000 signed kv
# txs (the first all new keys, then 700 updates and 300 new), values of 960
# bytes so a block, even block 1 with no LastCommit, is over 1 MB
# (BASELINE.json's 1 MB block): 17 or more 64 KB parts, over the Hasher's
# 16-leaf gate. 7 heights, not 24, for the smoke's clock since phases 33-36
# (8 before phases 35-36; the upgrade moved with them: two aggregate heights; block
# 5, which peer C tampers, keeps a full LastCommit)
FASTSYNC_HEIGHTS = 7
FASTSYNC_UPGRADE_HEIGHT = 6
FASTSYNC_FIRST_BLOCK = (("new", 1_000),)
FASTSYNC_BLOCK = (("update", 700), ("new", 300))
FASTSYNC_VALUE_BYTES = 960
FASTSYNC_SIGNERS = 64
FASTSYNC_TAMPER_HEIGHT = 4  # phase 29's peer C flips a signature of block 5's LastCommit
# phase 30: phase 29's pair alone (a second pair took 96 s of the smoke's
# clock, which phases 31-32 need)
FASTSYNC_TIME_RUNS = 1
FASTSYNC_SYNC_S = 600.0  # the bound on each wait of a sync
# the nodes' p2p config: 5,120,000 B/s each way, and a 10 ms flush throttle
# (the MConnection sends at most 64 packets a wake-up, so the default 100 ms
# caps a connection near 0.64 MB/s)
FASTSYNC_P2P = {"send_rate": 5_120_000, "recv_rate": 5_120_000, "flush_throttle_timeout": 0.01}
# phases 31-32, the consensus_committee cell: benches/bench_committee.py's
# largest committee (BENCH_r22.json's wire:n=400), phase 3's first 400 keys,
# default ConsensusParams, an upgrade to aggregate commits at height 7
# (docs/upgrade.md); 8 heights (the bench runs 3) of 1,000 signed kv txs and
# 10 forged ones (phase 27's families; fast sync's 960-byte values, so a
# block of over 1 MB has 17 or more 64 KB parts, over the Hasher's gate),
# then a restart and 2 more heights. 8 heights, not 12, for the smoke's
# clock since phases 33-36 (9 before phases 35-36; four aggregate heights, 7-10)
COMMITTEE_VALIDATORS = 400
COMMITTEE_HEIGHTS = 8
COMMITTEE_RESTART_HEIGHTS = 2
COMMITTEE_UPGRADE_HEIGHT = 7
COMMITTEE_FIRST_BLOCK = (("new", 1_000), ("forged", 10))
COMMITTEE_BLOCK = (("update", 700), ("new", 300), ("forged", 10))
COMMITTEE_VALUE_BYTES = 960
COMMITTEE_FORGED_HEIGHT = 3  # one stub's precommit carries a flipped signature
COMMITTEE_WAIT_S = 120.0  # the bound on each wait of the pump
COMMITTEE_REFERENCE_S = 600.0  # the bound on the host reference's two sessions
# phases 33-34, the gossip_net cell: benches/bench_committee.py's 100
# committee (BENCH_r22.json's wire:n=100), phase 3's first 100 keys, default
# ConsensusParams, an upgrade to aggregate commits at height 3
# (docs/upgrade.md); four port validators V0-V3 (gossip_power) and 96 stubs
# at power 1 behind one peer; 5 heights of phase 31's bursts, fed through one
# node a height; V3 starts empty once V0-V2 have committed height 3, so it
# catches up height 1 by precommits, 2 by an aggregate commit and 3 by
# precommits, then proposes 5. The cut: 5 heights (10 took 353 s on the card;
# 8, upgrade 5 and V3 after 6 before phases 35-36), for their clock (PERF.md §4)
GOSSIP_VALIDATORS = 100
GOSSIP_HEIGHTS = 5
GOSSIP_UPGRADE_HEIGHT = 3
GOSSIP_LATE_AFTER = 3
GOSSIP_FORGED_HEIGHT = 3  # stub 0's precommit to V0 carries a flipped signature
# V0-V3: the keys at these places in address order, at these powers (3 x 17 + 1
# of 148, 35%); the rotation then elects V1, V0, V2 at heights 1-3, a stub at
# 4, V3 at 5 and a stub at 6 (gossip_power checks it)
GOSSIP_NODE_KEYS = (3, 0, 6, 2)
GOSSIP_NODE_POWER = (17, 17, 17, 1)
GOSSIP_MIN_PARTS = 17  # every block is over 1 MB: 17 or more 64 KB parts
GOSSIP_INDEX_SAMPLE = 8  # a block's txs whose tx-index records are compared
GOSSIP_WAIT_S = 120.0  # the bound on each wait of the pump
# phases 35-36, the state_sync cell: a node joins phase 29's 1,000-validator
# chain (upgrade_height FASTSYNC_UPGRADE_HEIGHT) whose app holds phase 25's
# 250,000-key state from genesis; A builds STATESYNC_HEIGHTS heights of fast
# sync's bursts and snapshots STATESYNC_SNAPSHOT_HEIGHT (the light walk to it
# and the next height crosses the upgrade); C restores it and fast-syncs the
# tail to A's height less one. Height 7, not 5, leaves a one-block tail: the
# host reference C', which checks each aggregate commit on the host (seconds
# each at 1,001 lanes, two a tail block), then ends soon after C
STATESYNC_HEIGHTS = 9
STATESYNC_SNAPSHOT_HEIGHT = 7
STATESYNC_APP_FILE = "app-state.json"  # A's app state at its height less one, for its RPC's app
STATESYNC_SAMPLE_KEYS = 64  # keys (half from the genesis state, half from the bursts) C must hold as A
STATESYNC_PROOF_KEYS = 8  # present keys of the sample, and as many absent ones, proven over A's RPC
STATESYNC_SYNC_S = 600.0  # the bound on each wait of the state sync
REPLICA_WAIT_S = 120.0  # the bound on the replica's walk to A's last height
# phases 37-38, the node_validator cell: one port Node, built by
# default_new_node from its home, a validator of benches/bench_committee.py's
# 100 committee (BENCH_r22.json's wire:n=100; phase 3's first 100 keys) at
# committee_power's power, the other 99 keys the pump's stubs, an upgrade to
# aggregate commits at height 3; 6 heights of phase 31's bursts, each over
# the node's own RPC from NODE_RPC_CLIENTS threads, a forged stub precommit at
# the last height before the stop (its missing precommit then holds no later
# height for the commit timeout), then a second Node from the same home for
# 2 more. A started node waits NODE_TIMEOUT_COMMIT before its first height, the
# window in which its first burst arrives over RPC (the node proposes height 1)
NODE_VALIDATORS = 100
NODE_HEIGHTS = 6
NODE_RESTART_HEIGHTS = 2
NODE_UPGRADE_HEIGHT = 3
NODE_FORGED_HEIGHT = 6
NODE_RPC_CLIENTS = 64
NODE_SNAPSHOT_INTERVAL = 4
NODE_TIMEOUT_COMMIT = 3.0
NODE_INDEX_SAMPLE = 8  # a block's txs whose tx-index records are compared
NODE_WAIT_S = 120.0  # the bound on each wait of the pump
# phases 39-40, the localnet cell: the reference's `testnet` default and
# test/p2p's fleet of 4 validators (tendermint_tpu/cli.py:324) at equal power, as
# `python -m tendermint_tpu_torch.cli node` processes generated by the port's
# ops/localnet (the signed kvstore, sqlite, a full mesh through netfaults link
# proxies, aggregate commits from height 3), fed LOCALNET_BURSTS of phase 37's
# bursts at node 0's RPC, one a height. The cut: 4 burst heights. A burst is
# sent in the LOCALNET_TIMEOUT_COMMIT window before a proposal (height 1's
# start window, then the window after each commit), the time in which it
# reaches node 0 and, relayed by the mempool reactor, the proposer
LOCALNET_NODES = 4
LOCALNET_BURSTS = 4
LOCALNET_UPGRADE_HEIGHT = 3
LOCALNET_TIMEOUT_COMMIT = 10.0
LOCALNET_TIMEOUT_PROPOSE = 10.0
LOCALNET_TIMEOUT_VOTE = 2.0
LOCALNET_READ_KEYS = 8  # present keys the replica serves, and as many absent ones
LOCALNET_WAIT_S = 120.0  # the bound on each wait of the phase
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
# phase 21's daemon launches beside each kernel's entry in the kernels line
DEVD_LAUNCH_KEYS = {"ed25519_verify": "b1", "ed25519_comb": "comb", "ed25519_comb_tables": "tables",
                    "ed25519_dsm": "dsm", "ripemd160": "ripemd160", "merkle_tree": "merkle_tree"}


LAUNCHED = time.monotonic()


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def phase_start(n: int, what: str) -> None:
    """A line of its own as each phase starts: seconds since launch."""
    log({"phase_start": n, "what": what, "t_s": round(time.monotonic() - LAUNCHED, 3)})


def last_launch_line(text: str) -> dict[str, int] | None:
    """The counts on the last `kernel launches {...}` line of a process's
    log (the daemon's `stats` op, a stopped `cli node` or `cli replica`),
    or None."""
    lines = [ln for ln in text.splitlines() if "kernel launches " in ln]
    return json.loads(lines[-1].split("kernel launches ", 1)[1]) if lines else None


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median device time of fn() over `reps` runs, CUDA events around each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, kernel: str, calls: int = 5) -> float:
    """The device time of one launch of the CUDA kernel whose name holds
    `kernel`, over `calls` calls of fn() (torch.profiler, after a warm-up
    call): the kernel alone, without the host's launch path that a CUDA
    event pair around a short kernel also holds. The profiler drops a
    trace's device events now and then, so the time is a mean over the
    launches the trace holds, and a trace that holds none is taken again,
    up to PROFILE_TRIES traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages() if kernel in e.key]
        total = sum((getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)) for e in seen)
        if total:
            return total / 1e3 / sum(e.count for e in seen)
        log({"phase": "profiler_retry", "kernel": kernel, "trace": attempt + 1})
    raise RuntimeError(f"the profiler saw no device time for {kernel} in {PROFILE_TRIES} traces")


def bound_ms(module, lanes: int) -> tuple[float, str]:
    """The least time the card could take for a kernel module's lanes: its
    limb products over the integer multiply rate, or its bytes over the
    memory rate, whichever is larger."""
    ops_ms = 1e3 * module.PRODUCTS_PER_LANE * lanes / INT_MUL_PER_S
    bytes_ms = 1e3 * module.BYTES_PER_LANE * lanes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def ptxas_summary(build_log: str) -> list[dict]:
    """Per entry function of a build's `-Xptxas -v` output: registers,
    stack frame, spill stores and spill loads, static shared memory
    (bytes)."""
    import re

    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?", line)
        if m and "entry function" in line:
            cur = {"function": m.group(1)}
            out.append(cur)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur is not None:
            cur["static_smem_bytes"] = int(m.group(1))
    return out


def sass_counts(lib_path: str, marks: dict[str, str] | None = None) -> dict[str, dict]:
    """Per function in a library's SASS (cuobjdump): IMAD.WIDE of two
    registers (a limb product), IMAD.WIDE by an immediate (address
    arithmetic), other IMAD, the hash kernels' ALU_OPS (by opcode), and all
    instructions; and the same counts, with shuffles and local loads and
    stores, inside the function's longest loop (the widest backward branch:
    in B1 and dsm, one ladder step). With `marks` (label -> regex), also
    under "marked_loops" each label's loop: of the innermost loops around
    the instructions that match, the widest, with its addresses. The
    listing is kept beside the library (lib<name>.so.sass)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    with open(lib_path + ".sass", "w") as f:
        f.write(sass)
    listing, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            listing[fn] = []
        elif fn is not None and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)):
            listing[fn].append((int(m.group(1), 16), m.group(2)))

    def tally(instrs) -> dict[str, int]:
        c = {"IMAD.WIDE": 0, "IMAD.WIDE_imm": 0, "IMAD": 0, "SHFL": 0, "LDL": 0, "STL": 0,
             **{op: 0 for op in ALU_OPS}, "instructions": len(instrs)}
        for _, ins in instrs:
            if "IMAD.WIDE" in ins:
                c["IMAD.WIDE_imm" if re.search(r"IMAD\.WIDE\S* [^;]*, 0x", ins) else "IMAD.WIDE"] += 1
            else:
                for op in ("IMAD", "SHFL", "LDL", "STL"):
                    c[op] += op in ins
            # the hash kernels' ALU work, by opcode (a predicate guard first)
            base = ins.split()[1 if ins.startswith("@") else 0].split(".")[0]
            if base in ALU_OPS:
                c[base] += 1
        return c

    counts = {}
    for fn, instrs in listing.items():
        back = [(addr - int(m.group(1), 16), int(m.group(1), 16), addr) for addr, ins in instrs
                if (m := re.search(r"BRA\s+0x([0-9a-f]+)", ins)) and int(m.group(1), 16) < addr]
        counts[fn] = tally(instrs)
        if back:
            _, lo, hi = max(back)
            counts[fn]["longest_loop"] = tally([(a, ins) for a, ins in instrs if lo <= a <= hi])
        for label, pattern in (marks or {}).items():
            inner = {min(loop for loop in back if loop[1] <= addr <= loop[2])
                     for addr, ins in instrs
                     if re.search(pattern, ins) and any(lo <= addr <= hi for _, lo, hi in back)}
            if inner:
                _, lo, hi = max(inner)
                counts[fn].setdefault("marked_loops", {})[label] = {
                    "start": lo, "end": hi, **tally([(a, ins) for a, ins in instrs if lo <= a <= hi])}
    return counts


def check_multiply_rate(name: str, power: str) -> None:
    """Phase 1's check of the bound's yardstick. In the SASS: how many
    IMAD.WIDE one field multiplication and one squaring compile to, and so
    the limb products a B1, a B2 and a dsm lane issue; the static IMAD.WIDE count
    of each kernel library, and each probe loop's (one product a step, and
    nothing else but its counter and branch). On the card: the rate of the
    IMAD.WIDE microkernel and of a 32-bit IMAD one, in products per second
    over the whole card, swept over 4, 8, 16 and 32 chains a thread and 1,
    2, 4 and 8 blocks of 256 threads an SM; the plateau (the highest rate) is
    the yardstick, logged beside INT_MUL_PER_S."""
    import re

    import torch

    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops import kernels

    lib_of = {k: os.path.join(kernels.BUILD_DIR, f"lib{k}.so") for k in (PROBE, *KERNEL_NAMES)}
    probe = sass_counts(lib_of[PROBE])
    per_mul = next(c["IMAD.WIDE"] for f, c in probe.items() if "fe_mul_probe" in f)
    per_sq = next(c["IMAD.WIDE"] for f, c in probe.items() if "fe_sq_probe" in f)
    per_lane = {kname: {"sass": module.MULS_PER_LANE * per_mul + module.SQS_PER_LANE * per_sq,
                        "counted": module.PRODUCTS_PER_LANE}
                for kname, module in (("ed25519_verify", f32p), ("ed25519_verify_b2", b2),
                                      ("ed25519_dsm", ed32))}
    libs = {k: sass_counts(lib_of[k]) for k in KERNEL_NAMES}
    static = {k: sum(c["IMAD.WIDE"] for c in fns.values()) for k, fns in libs.items()}
    # the kernel function's longest loop: one two-bit ladder step of one
    # thread (B1, dsm) or one single-bit step (B2)
    loops = {k: next(c.get("longest_loop") for f, c in fns.items() if f"{k}_kernel" in f)
             for k, fns in libs.items()}
    log({"phase": "sass", "imad_wide_per_fe_mul": per_mul, "imad_wide_per_fe_sq": per_sq,
         "limb_products_per_lane": per_lane, "static_imad_wide_per_library": static,
         "kernel_longest_loop": loops, "probe_functions": probe})

    lib = kernels.load(PROBE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, per_sm_products = 256, 256 * 8192 * 64  # the same work at every point of the sweep
    out = torch.empty(8 * sms * threads, dtype=torch.int64, device=DEVICE)
    # each probe loop's SASS: its products (IMAD.WIDE of two registers, or
    # IMAD; two a step wide, one narrow) and every other instruction (the
    # loop's counter and branch)
    loop_sass = {}
    for f, c in probe.items():
        m = re.search(r"imad_rate_kernelILb([01])ELi(\d+)E", f)
        if m and "longest_loop" in c:
            loop = c["longest_loop"]
            made = loop["IMAD.WIDE" if m.group(1) == "1" else "IMAD"]
            loop_sass[f"{'wide' if m.group(1) == '1' else 'narrow'}x{m.group(2)}"] = {
                "products": made, "other": loop["instructions"] - made}
    sweep, plateau = [], {}
    for wide, label in ((1, "imad_wide_per_s"), (0, "imad_per_s")):
        for chains in (4, 8, 16, 32):
            for per_sm in (1, 2, 4, 8):
                per_thread = per_sm_products // (per_sm * threads)
                blocks, iters = per_sm * sms, per_thread // (chains * (1 + wide))

                def launch() -> None:
                    rc = lib.tm_imad_rate(wide, chains, out.data_ptr(), iters, blocks, threads,
                                          torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"imad_rate launch failed: cudaError {rc}")

                rate = blocks * threads * iters * chains * (1 + wide) / (cuda_ms(launch) / 1e3)
                sweep.append({"wide": wide, "chains": chains, "blocks_per_sm": per_sm, "per_s": rate})
                plateau[label] = max(plateau.get(label, 0.0), rate)
    log({"phase": "multiply_rate", "card": name, "power_limit": power, "sms": sms,
         "threads": threads, "loop_sass": loop_sass, "sweep": sweep, **plateau,
         "wide_over_narrow": plateau["imad_wide_per_s"] / plateau["imad_per_s"],
         "int_mul_per_s": INT_MUL_PER_S,
         "int_mul_per_s_over_plateau": INT_MUL_PER_S / plateau["imad_wide_per_s"]})


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def expect_refusal(label: str, fn, want: str) -> str:
    """Run fn, which must raise CommitError starting with `want`."""
    from tendermint_tpu_torch.types.validator_set import CommitError

    try:
        fn()
    except CommitError as exc:
        if not str(exc).startswith(want):
            raise AssertionError(f"{label}: wrong refusal {exc}") from exc
        return str(exc)[:60]
    raise AssertionError(f"{label} was accepted")


# -- set-up: keys, signatures, commits ---------------------------------------


def mixed_items(pool, rng, seeds, pubs, n: int):
    """n lanes mixing the verify families of the JAX package's tests:
    valid, tampered sig, tampered msg, wrong pub, s >= L, non-canonical
    R.y, short pub, long sig, invalid point, and one key over many
    messages."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    n_keys = min(64, len(seeds))
    fam = rng.integers(0, 10, size=n)
    keys = rng.integers(0, n_keys, size=n)
    keys[fam == 9] = 0  # identical keys, many messages
    msgs = [b"smoke-%d-%d" % (i, int(rng.integers(1 << 30))) for i in range(n)]
    sigs = pool.starmap(ed.sign, [(seeds[k], m) for k, m in zip(keys, msgs)], chunksize=64)
    items = []
    for i in range(n):
        k, pub, msg, sig = int(keys[i]), pubs[int(keys[i])], msgs[i], sigs[i]
        f = int(fam[i])
        if f == 1:
            j = int(rng.integers(64))
            sig = sig[:j] + bytes([sig[j] ^ (1 << int(rng.integers(8)))]) + sig[j + 1 :]
        elif f == 2:
            msg = msg + b"!"
        elif f == 3:
            pub = pubs[(k + 1) % n_keys]
        elif f == 4:
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + ed.L).to_bytes(32, "little")
        elif f == 5:
            sig = (ed.P + int(rng.integers(1, 19))).to_bytes(32, "little") + sig[32:]
        elif f == 6:
            pub = pub[:31]
        elif f == 7:
            sig = sig + b"\x00"
        elif f == 8:
            pub = b"\x01" * 32
        items.append((pub, msg, sig))
    return items


def make_commit(pool, vs, seed_of, height: int, tag: bytes):
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto.keys import SignatureEd25519
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote

    bid = BlockID(
        hashlib.sha256(tag + b"%d" % height).digest()[:20],
        PartSetHeader(1, hashlib.sha256(b"parts" + tag).digest()[:20]),
    )
    votes = [
        Vote(v.address, idx, height, 0, VOTE_TYPE_PRECOMMIT, bid)
        for idx, v in enumerate(vs.validators)
    ]
    sb = votes[0].sign_bytes(CHAIN_ID)  # identical for every validator
    sigs = pool.starmap(ed.sign, [(seed_of[v.address], sb) for v in vs.validators], chunksize=64)
    return bid, Commit(bid, [v.with_signature(SignatureEd25519(s)) for v, s in zip(votes, sigs)])


def recorded_items(vs, height, bid, commit):
    """The exact batch verify_commit hands its batch verifier."""
    seen = []
    vs.verify_commit(
        CHAIN_ID, bid, height, commit,
        batch_verifier=lambda items: (seen.append(items), [True] * len(items))[1],
    )
    return seen[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, SignatureEd25519
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32 as f32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.ops.gateway import Verifier
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    # -- phase 1: card and build ---------------------------------------------
    phase_start(1, "card and build")
    card = card_line()
    name, power = [s.strip() for s in card.split(",", 1)]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    ptxas = {}
    for kname, build_s in kernels.build_all(KERNEL_NAMES + COMB_NAMES + HASH_NAMES + (PROBE,)).items():
        log({"phase": "build", "kernel": kname, "seconds": build_s})
        ptxas[kname] = ptxas_summary(kernels.build_log.get(kname, ""))
        for entry in ptxas[kname]:
            log({"phase": "ptxas", "kernel": kname, **entry})
    check_multiply_rate(name, power)
    for kname in COMB_NAMES:  # IMAD.WIDE a comb step (two stages: 200 a thread) and a table addition
        log({"phase": "sass", "kernel": kname,
             "functions": sass_counts(os.path.join(kernels.BUILD_DIR, f"lib{kname}.so"))})
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("native host library did not build (make -C native)")
    log({"phase": "build", "kernel": "native host library", "seconds": time.perf_counter() - t0})

    # -- set-up: keys, signatures and commits from one seed ---------------------
    phase_start(0, "set-up: keys, signatures, commits, signed txs")
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    n_small, n_mid, n_keys = SET_SIZES
    seeds = [rng.bytes(32) for _ in range(n_keys)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=min(8, os.cpu_count() or 1)) as pool:
        pubs = pool.map(ed.public_key, seeds, chunksize=128)
        seed_of = {}
        validators = []
        for s, p in zip(seeds, pubs):
            v = Validator.new(PubKeyEd25519(p), 10)
            seed_of[v.address] = s
            validators.append(v)
        mixed = mixed_items(pool, rng, seeds, pubs, MIXED_LANES)
        vs100 = ValidatorSet(validators[:n_small])
        vs1000 = ValidatorSet(validators[:n_mid])
        vs10k = ValidatorSet(validators)
        bid100, c100 = make_commit(pool, vs100, seed_of, 1, b"c100")
        group = [(*make_commit(pool, vs1000, seed_of, h, b"c1000"), h) for h in range(1, 5)]
        bid10k, c10k = make_commit(pool, vs10k, seed_of, 1, b"c10k")
        vs400 = ValidatorSet(validators[: AGG_SIZES[1]])
        bid400, c400 = make_commit(pool, vs400, seed_of, 1, b"c400")
        t_app = time.perf_counter()
        app_inputs = make_app_inputs(pool, np.random.default_rng(SEED + 25))
        app_inputs_s = time.perf_counter() - t_app
        t_exec = time.perf_counter()
        exec_inputs = make_exec_inputs(pool, np.random.default_rng(SEED + 27))
        exec_inputs_s = time.perf_counter() - t_exec
        t_fs = time.perf_counter()
        fastsync_inputs = make_fastsync_inputs(pool, np.random.default_rng(SEED + 29))
        fastsync_inputs_s = time.perf_counter() - t_fs
        t_cmt = time.perf_counter()
        committee_inputs = make_committee_inputs(pool, np.random.default_rng(SEED + 31))
        committee_inputs_s = time.perf_counter() - t_cmt
        t_gsp = time.perf_counter()
        gossip_inputs = make_gossip_inputs(pool, np.random.default_rng(SEED + 33))
        gossip_inputs_s = time.perf_counter() - t_gsp
        t_ss = time.perf_counter()
        statesync_inputs = make_statesync_inputs(pool, np.random.default_rng(SEED + 35))
        statesync_inputs_s = time.perf_counter() - t_ss
        t_node = time.perf_counter()
        node_inputs = make_node_inputs(pool, np.random.default_rng(SEED + 37))
        node_inputs_s = time.perf_counter() - t_node
        t_lnet = time.perf_counter()
        localnet_inputs = make_localnet_inputs(pool, np.random.default_rng(SEED + 39))
    log({"phase": "setup", "keys": n_keys,
         "signatures": MIXED_LANES + n_small + 4 * n_mid + n_keys + AGG_SIZES[1],
         "app_state_keys": APP_STATE_KEYS, "app_signed_txs": sum(len(b["txs"]) for b in app_inputs["blocks"]),
         "app_inputs_s": app_inputs_s, "exec_signed_txs": sum(len(b["txs"]) for b in exec_inputs),
         "exec_inputs_s": exec_inputs_s, "fastsync_signed_txs": sum(len(b["txs"]) for b in fastsync_inputs),
         "fastsync_inputs_s": fastsync_inputs_s,
         "committee_signed_txs": sum(len(b["txs"]) for b in committee_inputs),
         "committee_inputs_s": committee_inputs_s,
         "gossip_signed_txs": sum(len(b["txs"]) for b in gossip_inputs),
         "gossip_inputs_s": gossip_inputs_s,
         "statesync_signed_txs": sum(len(b["txs"]) for b in statesync_inputs),
         "statesync_inputs_s": statesync_inputs_s,
         "node_signed_txs": sum(len(b["txs"]) for b in node_inputs),
         "node_inputs_s": node_inputs_s, "localnet_signed_txs": sum(len(b["txs"]) for b in localnet_inputs),
         "localnet_inputs_s": time.perf_counter() - t_lnet, "seconds": time.perf_counter() - t0})

    # -- phase 2: kernel vs plain version on the card ---------------------------
    phase_start(2, "kernel vs plain version")
    group_items = [it for bid, c, h in group for it in recorded_items(vs1000, h, bid, c)]
    shapes = {
        "mixed": mixed,
        "commit_small": recorded_items(vs100, 1, bid100, c100),
        "fast_sync_group": group_items,
        "commit_large": recorded_items(vs10k, 1, bid10k, c10k),
    }
    max_err = 0
    whole = {}  # per shape, B1's and the plain version's lanes, for phase 10
    for label, items in shapes.items():
        args, valid, n = f32p.marshal_device_args(items, DEVICE)
        t0 = time.perf_counter()
        got = f32p.verify_lanes(*args)
        want = f32.verify_plain(args[0].float(), args[1].float(), args[2].float(), args[3],
                                args[4].int(), args[5].int()).to(torch.int32)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        max_err = max(max_err, err)
        whole[label] = {"b1": got.cpu(), "plain": want.cpu()}
        verdicts = f32p.materialize_verdicts(got.cpu(), valid, n)
        log({"phase": "kernel_vs_plain", "shape": label, "lanes": n, "accepted": int(verdicts.sum()),
             "max_abs_err": err, "seconds": time.perf_counter() - t0})
        if err != 0:
            bad = torch.nonzero(got != want).flatten()[:10].tolist()
            raise AssertionError(f"{label}: kernel disagrees with verify_plain at lanes {bad}")
        if label == "mixed":
            sample = rng.choice(n, size=min(256, n), replace=False)
            ref = np.array([ed.verify(*items[i]) for i in sample])
            if not np.array_equal(verdicts[sample], ref):
                raise AssertionError("mixed: kernel verdicts disagree with crypto.ed25519.verify")
            families = sorted({bool(x) for x in ref})
            log({"phase": "reference_sample", "lanes": len(sample), "verdicts_seen": families})
        elif not verdicts.all():
            raise AssertionError(f"{label}: a valid commit signature was rejected")
    # the plain version once over the widest ragged count: a lane's verdict
    # depends on its own signature only
    args, _, _ = f32p.marshal_device_args(mixed[:max(RAGGED_LANES)], DEVICE)
    ragged_want = f32.verify_plain(args[0].float(), args[1].float(), args[2].float(), args[3],
                                   args[4].int(), args[5].int()).to(torch.int32)
    for n in RAGGED_LANES:
        args, _, _ = f32p.marshal_device_args(mixed[:n], DEVICE)
        got = f32p.verify_lanes(*args)
        want = ragged_want[:got.shape[0]]
        err = int((got - want).abs().max().item())
        max_err = max(max_err, err)
        log({"phase": "kernel_vs_plain", "shape": "ragged", "lanes": n, "max_abs_err": err})
        if err != 0:
            bad = torch.nonzero(got != want).flatten()[:10].tolist()
            raise AssertionError(f"ragged {n}: kernel disagrees with verify_plain at lanes {bad}")
    torch.cuda.synchronize()

    # -- phase 3: the main path through ValidatorSet and Verifier ---------------
    phase_start(3, "main path")
    forged = Commit(bid100, list(c100.precommits))
    p7 = forged.precommits[7]
    raw = bytearray(p7.signature.raw)
    raw[5] ^= 0x20
    forged.precommits[7] = p7.with_signature(SignatureEd25519(bytes(raw)))
    keep = 2 * n_small // 3  # exactly 2/3 of the power: not more than 2/3
    sub_quorum = Commit(bid100, [p if i < keep else None for i, p in enumerate(c100.precommits)])

    v = Verifier(device=DEVICE)
    wall = {}
    f32p.launches = b2.launches = ed32.launches = 0
    t0 = time.perf_counter()
    vs100.verify_commit(CHAIN_ID, bid100, 1, c100, batch_verifier=v.commit_batch_verifier())
    wall["commit_small"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    finishers = vs1000.verify_commits_async(
        CHAIN_ID, [(bid, h, c) for bid, c, h in group], v.verify_batch_async
    )
    for finish in finishers:
        finish()
    wall["fast_sync_group"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs10k.verify_commit(CHAIN_ID, bid10k, 1, c10k, batch_verifier=v.commit_batch_verifier())
    wall["commit_large"] = time.perf_counter() - t0
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    main_launches = f32p.launches
    others = {"b2": b2.launches, "dsm": ed32.launches}
    stats = v.stats()
    log({"phase": "main_path", "launches": main_launches, "other_launches": others,
         "stats": stats, "wall_s": wall, "refused": refusals})
    if main_launches != 5 or stats["tpu_batches"] != 5 or others != {"b2": 0, "dsm": 0}:
        raise AssertionError(f"expected 5 B1 batches and no other launch: {main_launches} "
                             f"launches, {others}, {stats}")
    if stats["cpu_sigs"] != 0:
        raise AssertionError(f"{stats['cpu_sigs']} main-path signatures fell to the CPU")

    # -- phase 4: times ---------------------------------------------------------
    phase_start(4, "times")
    warm = {
        "commit_small": lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, c100, batch_verifier=v.commit_batch_verifier()),
        "fast_sync_group": lambda: [f() for f in vs1000.verify_commits_async(
            CHAIN_ID, [(bid, h, c) for bid, c, h in group], v.verify_batch_async)],
        "commit_large": lambda: vs10k.verify_commit(
            CHAIN_ID, bid10k, 1, c10k, batch_verifier=v.commit_batch_verifier()),
    }
    for label, fn in warm.items():
        log({"phase": "commit_time", "card": name, "power_limit": power, "commit": label,
             "validators": {"commit_small": n_small, "fast_sync_group": 4 * n_mid,
                            "commit_large": n_keys}[label],
             "first_s": wall[label], "warm_best_of_3_s": min(timed(fn) for _ in range(3))})

    kernel_ms = {}
    for lanes in TIME_LANES:
        items = (mixed * (lanes // len(mixed) + 1))[:lanes]
        args, _, _ = f32p.marshal_device_args(items, DEVICE)
        ms = cuda_ms(lambda: f32p.verify_lanes(*args))
        kernel_ms[lanes] = ms
        b_ms, b_by = bound_ms(f32p, lanes)
        log({"phase": "kernel_time", "card": name, "power_limit": power, "lanes": lanes,
             "ms": ms, "sigs_per_s": lanes / ms * 1e3, "bound_ms": b_ms, "bound_by": b_by})
    args, _, _ = f32p.marshal_device_args(mixed, DEVICE)
    plain_args = (args[0].float(), args[1].float(), args[2].float(), args[3],
                  args[4].int(), args[5].int())
    plain_ms = cuda_ms(lambda: f32.verify_plain(*plain_args), reps=PLAIN_TIME_REPS, warmup=0)
    log({"phase": "plain_time", "card": name, "power_limit": power, "lanes": MIXED_LANES,
         "ms": plain_ms})

    # where a warm large commit's wall time goes, stage by stage
    large = shapes["commit_large"]
    args, _, _ = f32p.marshal_device_args(large, DEVICE)
    log({"phase": "commit_breakdown", "card": name, "power_limit": power, "lanes": len(large),
         "structural_and_tally_s": min(timed(lambda: recorded_items(vs10k, 1, bid10k, c10k))
                                       for _ in range(3)),
         "prepare_batch8_s": min(timed(lambda: f32.prepare_batch8(large, len(large)))
                                 for _ in range(3)),
         "marshal_and_copy_s": min(timed(lambda: f32p.marshal_device_args(large, DEVICE))
                                   for _ in range(3)),
         "kernel_s": cuda_ms(lambda: f32p.verify_lanes(*args)) / 1e3})

    sample = large[:512]
    best = min(timed(lambda: native.ed25519_verify_batch(sample)) for _ in range(3))
    log({"phase": "cpu_baseline", "card": name, "power_limit": power,
         "method": "native batch verifier, fixed 512 signatures, best of 3",
         "sigs_per_s": len(sample) / best})

    # -- phases 5 to 9: B2, the dsm kernel, and the paths they carry ----------
    commits = {"commit_small": (vs100, bid100, c100), "fast_sync_group": (vs1000, group),
               "commit_large": (vs10k, bid10k, c10k), "agg_100": (vs100, bid100, c100),
               "agg_400": (vs400, bid400, c400)}
    phase_start(5, "B2 against its plain version")
    b2_err = check_b2(shapes, rng)
    phase_start(6, "dsm against its plain version")
    dsm_terms, dsm_err = check_dsm(rng, pubs[:256], commits["agg_100"])
    phase_start(7, "main path through B2")
    b2_launches, b2_runs, b2_wall = b2_main_path(commits, forged, sub_quorum)
    phase_start(8, "aggregate path")
    dsm_launches = aggregate_path(commits, sub_quorum)
    dsm_err = max(dsm_err, check_dsm_path_shapes(commits))
    phase_start(9, "B2 and dsm times")
    b2_ms, b2_plain_ms, dsm_ms, dsm_plain_ms = time_b2_and_dsm(
        name, power, mixed, dsm_terms, commits, b2_runs, b2_wall)

    # -- phases 10 to 12: B1' and the sharded main path ------------------------
    phase_start(10, "B1' against B1 and the plain version")
    sharded_err = check_sharded(shapes, whole)
    phase_start(11, "sharded main path")
    mixed_commit = make_mixed_commit(validators[: n_small - MIXED_SECP], seed_of, rng)
    sharded_launches = sharded_main_path(commits, forged, sub_quorum, mixed_commit)
    phase_start(12, "sharded times")
    sharded_ms = time_sharded(name, power, mixed, commits)

    # -- phases 13 to 17: the comb path and the torch compositions --------------
    phase_start(13, "comb kernels against their plain versions")
    comb_pool, comb_err = check_comb(shapes, whole, pubs, rng)
    phase_start(14, "main path through comb")
    comb_launches = comb_main_path(name, power, commits, forged, sub_quorum)
    phase_start(15, "a 64-slot comb pool")
    comb_small_pool(commits)
    phase_start(16, "torch compositions")
    registry_compositions(name, power, commits, mixed)
    phase_start(17, "comb times")
    comb_times = time_comb(name, power, comb_pool, shapes, group_items, pubs)
    del comb_pool

    # -- phases 18 to 20: the hash plane ----------------------------------------
    phase_start(18, "hash kernels against their plain versions")
    hash_err, hash_plain_s = check_hash_kernels(rng)
    phase_start(19, "main path of the hash plane")
    block_txs, params = make_block_txs(rng)
    hash_launches, built, hash_calls = hash_main_path(commits["commit_small"], block_txs, params)
    path_err = check_path_kernels(hash_calls, block_txs)
    phase_start(20, "hash times")
    hash_entries = time_hashes(name, power, commits["commit_small"], block_txs, built, hash_calls,
                               params, hash_plain_s)
    del hash_calls

    # -- phases 21 and 22: the device daemon --------------------------------------
    phase_start(21, "device daemon")
    one_daemon = devd_phase(name, power, commits, forged, sub_quorum, shapes, block_txs, params)
    devd_launches = one_daemon["launches"]

    # -- phases 23 and 24: the multi-daemon plane ----------------------------------
    phase_start(23, "multi-daemon plane")
    fleet_launches = fleet_phase(name, power, commits, forged, sub_quorum, shapes, block_txs, params,
                                 one_daemon)

    # -- phases 25 and 26: the ABCI application plane --------------------------------
    phase_start(25, "application plane")
    app_ctx = app_phase(name, power, app_inputs)
    phase_start(26, "application plane times")
    app_time(name, power, app_ctx)
    app_launches = app_ctx["launches"]
    state_entries = app_inputs["entries"]  # phase 35's genesis state
    del app_ctx, app_inputs

    # -- phases 27 and 28: the execution path --------------------------------------
    phase_start(27, "execution path")
    exec_ctx = exec_phase(name, power, vs100, seed_of, exec_inputs)
    phase_start(28, "execution path times")
    exec_time(name, power, exec_ctx)
    exec_launches = exec_ctx["launches"]
    del exec_ctx, exec_inputs

    # -- phases 29 and 30: the transport and fast sync -----------------------------
    phase_start(29, "transport and fast sync")
    fs_ctx = fastsync_phase(name, power, vs1000, seed_of, fastsync_inputs)
    try:
        phase_start(30, "fast-sync times")
        fastsync_time(name, power, fs_ctx)
    finally:
        fs_ctx["server"].close()
        shutil.rmtree(fs_ctx["root"], ignore_errors=True)
    fastsync_launches = fs_ctx["launches"]
    del fs_ctx, fastsync_inputs

    # -- phases 31 and 32: the consensus state machine ------------------------------
    phase_start(31, "consensus state machine")
    cmt_ctx = committee_phase(name, power, seeds, committee_inputs)
    phase_start(32, "consensus times")
    committee_time(name, power, cmt_ctx)
    committee_launches = cmt_ctx["launches"]
    del cmt_ctx, committee_inputs

    # -- phases 33 and 34: the gossip ------------------------------------------------
    phase_start(33, "gossip")
    gsp_ctx = gossip_phase(name, power, seeds, gossip_inputs)
    phase_start(34, "gossip times")
    gossip_time(name, power, gsp_ctx)
    gossip_launches = gsp_ctx["launches"]
    del gsp_ctx, gossip_inputs

    # -- phases 35 and 36: RPC, the light client and state sync -------------------
    phase_start(35, "RPC, light client and state sync")
    ss_ctx = statesync_phase(name, power, vs1000, seed_of, statesync_inputs, state_entries)
    phase_start(36, "state-sync times")
    statesync_time(name, power, ss_ctx)
    statesync_launches = ss_ctx["launches"]
    replica_launches = ss_ctx["replica_launches"]
    del ss_ctx, statesync_inputs, state_entries

    # -- phases 37 and 38: the node -------------------------------------------------
    phase_start(37, "node")
    node_ctx = node_phase(name, power, seeds, node_inputs)
    phase_start(38, "node times")
    node_time(name, power, node_ctx)
    node_launches = node_ctx["launches"]
    del node_ctx, node_inputs

    # -- phases 39 and 40: the localnet, port node processes started by the CLI ----
    phase_start(39, "localnet")
    lnet_ctx = localnet_phase(name, power, localnet_inputs)
    phase_start(40, "localnet times")
    localnet_time(name, power, lnet_ctx)
    localnet_launches = lnet_ctx["launches"]
    del lnet_ctx, localnet_inputs
    phase_start(41, "kernels line")

    entries = []
    for kname, module, launches, err, ms, p_ms, lanes in (
            ("ed25519_verify", f32p, main_launches, max_err, kernel_ms[MIXED_LANES], plain_ms,
             MIXED_LANES),
            ("ed25519_verify_b2", b2, b2_launches, b2_err, b2_ms, b2_plain_ms, MIXED_LANES),
            ("ed25519_dsm", ed32, dsm_launches, dsm_err, dsm_ms, dsm_plain_ms, DSM_LANES)):
        b_ms, b_by = bound_ms(module, lanes)
        entries.append({
            "name": kname, "route": "cuda", "source": f"{CSRC}{kname}.cu",
            "replaces": REPLACES[kname], "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "lanes": lanes,
        })
    # B1' on one card: the work of B1 over the same lanes, split 4 ways;
    # its plain version is verify_plain over those lanes (phase 4's time)
    b_ms, b_by = bound_ms(f32p, MIXED_LANES)
    entries.append({
        "name": "ed25519_verify_sharded", "route": "cuda", "source": f"{CSRC}ed25519_verify.cu",
        "replaces": REPLACES["ed25519_verify_sharded"], "launches": sharded_launches,
        "max_abs_err": sharded_err, "ms": sharded_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms / len(set(shard_meshes()["one_card"])), "bound_by": b_by, "library_ms": None,
        "lanes": MIXED_LANES, "shards": SHARDS,
    })
    for kname in COMB_NAMES:
        entries.append({
            "name": kname, "route": "cuda", "source": f"{CSRC}{kname}.cu",
            "replaces": REPLACES[kname], "launches": comb_launches[kname], "max_abs_err": comb_err[kname],
            **comb_times[kname], "library_ms": None, "ptxas": ptxas[kname],
        })
    # a hash kernel's difference: the largest over phase 18's batches, the
    # main path's own calls and phase 20's compared runs (the line's shape)
    for entry in hash_entries:
        kname = entry["name"]
        err = max(hash_err[kname], path_err[kname], entry.pop("max_abs_err"))
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"{CSRC}{'merkle_tree' if kname == 'merkle_tree' else 'hash_blocks'}.cu",
            "replaces": REPLACES[kname], "launches": hash_launches[kname],
            "max_abs_err": err, **entry,
            "ptxas": ptxas["merkle_tree" if kname == "merkle_tree" else "hash_blocks"],
        })
    for entry in entries:
        if entry["name"] in DEVD_LAUNCH_KEYS:
            entry["devd_launches"] = devd_launches[DEVD_LAUNCH_KEYS[entry["name"]]]
            entry["fleet_launches"] = fleet_launches[DEVD_LAUNCH_KEYS[entry["name"]]]
        if entry["name"] in APP_LAUNCH_KEYS:
            entry["app_launches"] = app_launches[APP_LAUNCH_KEYS[entry["name"]]]
        if entry["name"] in EXEC_LAUNCH_KEYS:
            entry["exec_launches"] = exec_launches[EXEC_LAUNCH_KEYS[entry["name"]]]
            entry["fastsync_launches"] = fastsync_launches[EXEC_LAUNCH_KEYS[entry["name"]]]
            entry["consensus_launches"] = committee_launches[EXEC_LAUNCH_KEYS[entry["name"]]]
            entry["gossip_launches"] = gossip_launches[EXEC_LAUNCH_KEYS[entry["name"]]]
            entry["statesync_launches"] = statesync_launches[EXEC_LAUNCH_KEYS[entry["name"]]]
            entry["replica_launches"] = replica_launches[EXEC_LAUNCH_KEYS[entry["name"]]]
            entry["node_launches"] = node_launches[EXEC_LAUNCH_KEYS[entry["name"]]]
            entry["localnet_launches"] = localnet_launches[EXEC_LAUNCH_KEYS[entry["name"]]]
    log({"kernels": entries})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def check_b2(shapes, rng) -> int:
    """Phase 5: B2's verdicts equal its plain version's on the mixed lanes,
    B1's on every shape, both on the first RAGGED_LANES of the mixed lanes
    (partial warps and blocks), and crypto.ed25519.verify on a sample.
    Returns the largest difference seen (0 when all agree)."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2

    max_err = 0
    plain_mixed = None
    for label, items in shapes.items():
        args, valid, n = f32p.marshal_device_args(items, DEVICE)
        t0 = time.perf_counter()
        got = b2.verify_lanes(*args)
        against = {"b1": f32p.verify_lanes(*args)}
        if label == "mixed":
            against["plain"] = plain_mixed = b2.verify_plain(*args).to(torch.int32)
        torch.cuda.synchronize()
        errs = {k: int((got - w).abs().max().item()) for k, w in against.items()}
        max_err = max(max_err, *errs.values())
        verdicts = f32p.materialize_verdicts(got.cpu(), valid, n)
        log({"phase": "b2_vs_plain_and_b1", "shape": label, "lanes": n,
             "accepted": int(verdicts.sum()), "max_abs_err": errs,
             "seconds": time.perf_counter() - t0})
        for k, w in against.items():
            if errs[k] != 0:
                bad = torch.nonzero(got != w).flatten()[:10].tolist()
                raise AssertionError(f"{label}: B2 disagrees with {k} at lanes {bad}")
        if label == "mixed":
            sample = rng.choice(n, size=min(256, n), replace=False)
            ref = np.array([ed.verify(*items[i]) for i in sample])
            if not np.array_equal(verdicts[sample], ref):
                raise AssertionError("mixed: B2 verdicts disagree with crypto.ed25519.verify")
        elif not verdicts.all():
            raise AssertionError(f"{label}: B2 rejected a valid commit signature")
    # a lane's verdict depends on its own inputs only, so the plain version's
    # first n mixed lanes are its verdicts on mixed[:n]
    for n in RAGGED_LANES:
        args, _, _ = f32p.marshal_device_args(shapes["mixed"][:n], DEVICE)
        got = b2.verify_lanes(*args)
        against = {"b1": f32p.verify_lanes(*args), "plain": plain_mixed[:n]}
        errs = {k: int((got - w).abs().max().item()) for k, w in against.items()}
        max_err = max(max_err, *errs.values())
        log({"phase": "b2_vs_plain_and_b1", "shape": "ragged", "lanes": n, "max_abs_err": errs})
        for k, w in against.items():
            if errs[k] != 0:
                bad = torch.nonzero(got != w).flatten()[:10].tolist()
                raise AssertionError(f"ragged {n}: B2 disagrees with {k} at lanes {bad}")
    return max_err


def _aggregate_args(vs, agg):
    """(pubs, msgs, rs, s_agg): what AggregateCommit.verify hands the
    aggregate verifier."""
    pubs = [vs.get_by_index(i)[1].pub_key.raw for i in agg.signers.indices()]
    return pubs, [agg.sign_message(CHAIN_ID)] * len(pubs), agg.rs, agg.s_agg


def _affine(pt) -> tuple[int, int]:
    from tendermint_tpu_torch.crypto import ed25519 as ed

    zinv = pow(pt[2], ed.P - 2, ed.P)
    return (pt[0] * zinv % ed.P, pt[1] * zinv % ed.P)


def check_dsm(rng, pubs, agg_case):
    """Phase 6: the dsm kernel against dsm_plain, bytes exactly, on
    DSM_LANES lanes from the seed (random scalars below L, validator key
    points, the edge lanes) ending in the real terms of a 100-validator
    aggregate commit; then 64 lanes against the pure-Python group law.
    Returns (terms, largest byte difference)."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    vs, _, commit = agg_case
    real = ed25519_agg.aggregate_terms(
        *_aggregate_args(vs, AggregateCommit.from_commit(commit, CHAIN_ID, vs)))
    points = [_affine(ed.point_decompress(p)) for p in pubs]

    def scalar() -> int:
        return int.from_bytes(rng.bytes(32), "little") % ed.L

    terms = []
    for i in range(DSM_LANES - len(real)):
        p, q = points[int(rng.integers(len(points)))], points[int(rng.integers(len(points)))]
        a, b = scalar(), scalar()
        kind = i % 8  # the edge lanes the complete formulas must cover
        if kind == 1:
            q = (0, 1)
        elif kind == 2:
            a = 0
        elif kind == 3:
            b = 0
        elif kind == 4:
            q = p
        elif kind == 5:
            q = ((-p[0]) % ed.P, p[1])
        elif kind == 6:
            a = b = 0
        terms.append((a, p, b, q))
    terms += real

    t0 = time.perf_counter()
    rows = ed32.marshal_dsm_args(terms, DEVICE)
    x8, y8 = ed32.dsm_lanes(*rows)
    px, py = ed32.dsm_plain(*(ed32.limbs_from_bytes(r) for r in rows))
    want = torch.stack([ed32.bytes_from_limbs(px), ed32.bytes_from_limbs(py)])
    got = torch.stack([x8, y8])
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max().item())
    log({"phase": "dsm_vs_plain", "lanes": len(terms), "real_aggregate_lanes": len(real),
         "max_abs_err": err, "seconds": time.perf_counter() - t0})
    if err != 0:
        bad = torch.nonzero((got != want).any(dim=(0, 1))).flatten()[:10].tolist()
        raise AssertionError(f"dsm kernel disagrees with dsm_plain at lanes {bad}")
    for n in RAGGED_LANES[:-1]:  # 1025 is DSM_LANES, just compared
        part = ed32.marshal_dsm_args(terms[:n], DEVICE)
        got_n = torch.stack(ed32.dsm_lanes(*part))
        err_n = int((got_n.int() - want[..., :n].int()).abs().max().item())
        log({"phase": "dsm_vs_plain", "shape": "ragged", "lanes": n, "max_abs_err": err_n})
        if err_n != 0:
            bad = torch.nonzero((got_n != want[..., :n]).any(dim=(0, 1))).flatten()[:10].tolist()
            raise AssertionError(f"ragged {n}: dsm kernel disagrees with dsm_plain at lanes {bad}")
        err = max(err, err_n)
    xy = got.cpu().numpy()
    sample = min(64, len(terms))
    for i in range(sample):
        a, p, b, q = terms[i]
        ref = _affine(ed.point_add(ed.scalar_mult(a, (p[0], p[1], 1, p[0] * p[1] % ed.P)),
                                   ed.scalar_mult(b, (q[0], q[1], 1, q[0] * q[1] % ed.P))))
        lane = tuple(int.from_bytes(xy[k, :, i].tobytes(), "little") for k in range(2))
        if lane != ref:
            raise AssertionError(f"dsm lane {i} disagrees with the pure-Python group law")
    log({"phase": "dsm_reference_sample", "lanes": sample, "equal": True})
    return terms, err


def b2_main_path(commits, forged, sub_quorum):
    """Phase 7: the phase-3 commits through a Verifier built under
    TENDERMINT_TPU_KERNEL=pallas. Returns (B2 launches, the commit runs,
    their first wall times)."""
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops.gateway import Verifier

    v = verifier_under("pallas", lambda: Verifier(device=DEVICE))
    vs100, bid100, c100 = commits["commit_small"]
    vs1000, group = commits["fast_sync_group"]
    vs10k, bid10k, c10k = commits["commit_large"]
    runs = {
        "commit_small": lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, c100, batch_verifier=v.commit_batch_verifier()),
        "fast_sync_group": lambda: [f() for f in vs1000.verify_commits_async(
            CHAIN_ID, [(bid, h, c) for bid, c, h in group], v.verify_batch_async)],
        "commit_large": lambda: vs10k.verify_commit(
            CHAIN_ID, bid10k, 1, c10k, batch_verifier=v.commit_batch_verifier()),
    }
    f32p.launches = b2.launches = ed32.launches = 0
    wall = {label: timed(fn) for label, fn in runs.items()}
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    launches = {"b2": b2.launches, "b1": f32p.launches, "dsm": ed32.launches}
    stats = v.stats()
    log({"phase": "b2_main_path", "kernel": v.kernel, "launches": launches, "stats": stats,
         "wall_s": wall, "refused": refusals})
    if launches != {"b2": 5, "b1": 0, "dsm": 0} or stats["tpu_batches"] != 5:
        raise AssertionError(f"expected 5 B2 batches and no other launch: {launches}, {stats}")
    if stats["cpu_sigs"] != 0:
        raise AssertionError(f"{stats['cpu_sigs']} B2-path signatures fell to the CPU")
    return launches["b2"], runs, wall


def aggregate_path(commits, sub_quorum) -> int:
    """Phase 8: 100- and 400-validator aggregate commits through
    ValidatorSet.verify_commit and verify_commits_async on the default
    verifier (the card), and three refusals. Returns the dsm launches."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.libs.bitarray import BitArray
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    dv = gateway.default_verifier()
    if dv.device.type != DEVICE:
        raise AssertionError(f"the default verifier runs on {dv.device}")
    aggs = {label: AggregateCommit.from_commit(commits[label][2], CHAIN_ID, commits[label][0])
            for label in ("agg_100", "agg_400")}
    vs100, bid100, c100 = commits["agg_100"]
    forged = AggregateCommit.from_bytes(aggs["agg_100"].to_bytes())
    forged.s_agg = ((int.from_bytes(forged.s_agg, "little") + 1) % ed.L).to_bytes(32, "little")
    dropped = AggregateCommit.from_bytes(aggs["agg_100"].to_bytes())
    dropped.signers.set_index(0, False)
    dropped.rs = dropped.rs[1:]
    keep = [i for i, p in enumerate(sub_quorum.precommits) if p is not None]
    rs, s_agg = ed25519_agg.aggregate([
        (vs100.get_by_index(i)[1].pub_key.raw, c100.precommits[i].sign_bytes(CHAIN_ID),
         c100.precommits[i].signature.raw) for i in keep])
    thin = AggregateCommit(bid100, 1, 0, BitArray.from_indices(vs100.size(), keep), rs, s_agg)

    before = dv.stats()
    f32p.launches = b2.launches = ed32.launches = 0
    wall, want_lanes = {}, 0
    for label, agg in aggs.items():
        vs, bid, _ = commits[label]
        wall[label] = timed(lambda: vs.verify_commit(CHAIN_ID, bid, 1, agg))
        fin = vs.verify_commits_async(CHAIN_ID, [(bid, 1, agg)], dv.verify_batch_async)
        fin[0]()
        want_lanes += 2 * (agg.num_signers() + 1)
    refusals = {
        "forged_s_agg": expect_refusal("forged aggregate", lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, forged), "aggregate signature failed verification"),
        "dropped_signer": expect_refusal("dropped-signer aggregate", lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, dropped), "aggregate signature failed verification"),
        "sub_quorum_aggregation": expect_refusal(
            "sub-quorum aggregation", lambda: AggregateCommit.from_commit(
                sub_quorum, CHAIN_ID, vs100), "aggregable precommits carry only"),
        "sub_quorum_aggregate": expect_refusal("sub-quorum aggregate", lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, thin), "insufficient voting power"),
    }
    want_lanes += (forged.num_signers() + 1) + (dropped.num_signers() + 1)
    launches = {"dsm": ed32.launches, "b1": f32p.launches, "b2": b2.launches}
    after = dv.stats()
    grew = {k: after[k] - before[k] for k in ("agg_batches", "agg_lanes_device", "agg_lanes_cpu")}
    log({"phase": "aggregate_path", "validators": [a.size() for a in aggs.values()],
         "signers": [a.num_signers() for a in aggs.values()], "launches": launches,
         "stats_grew": grew, "wall_s": wall, "refused": refusals})
    if grew != {"agg_batches": 6, "agg_lanes_device": want_lanes, "agg_lanes_cpu": 0}:
        raise AssertionError(f"expected 6 device aggregates of {want_lanes} lanes: {grew}")
    if launches != {"dsm": 6, "b1": 0, "b2": 0}:
        raise AssertionError(f"expected 6 dsm launches and no other: {launches}")
    return launches["dsm"]


def check_dsm_path_shapes(commits) -> int:
    """The dsm kernel against dsm_plain, bytes exactly, on the exact terms
    of the aggregate path's 100- and 400-validator commits (101 and 401
    lanes, so the last block is partial). Runs after the path's launch
    counts are read. Returns the largest byte difference."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    max_err = 0
    for label in ("agg_100", "agg_400"):
        vs, _, commit = commits[label]
        terms = ed25519_agg.aggregate_terms(
            *_aggregate_args(vs, AggregateCommit.from_commit(commit, CHAIN_ID, vs)))
        rows = ed32.marshal_dsm_args(terms, DEVICE)
        got = torch.stack(ed32.dsm_lanes(*rows))
        px, py = ed32.dsm_plain(*(ed32.limbs_from_bytes(r) for r in rows))
        want = torch.stack([ed32.bytes_from_limbs(px), ed32.bytes_from_limbs(py)])
        err = int((got.int() - want.int()).abs().max().item())
        log({"phase": "dsm_vs_plain_path_shape", "shape": label, "lanes": len(terms),
             "max_abs_err": err})
        if err != 0:
            bad = torch.nonzero((got != want).any(dim=(0, 1))).flatten()[:10].tolist()
            raise AssertionError(f"{label}: dsm kernel disagrees with dsm_plain at lanes {bad}")
        max_err = max(max_err, err)
    return max_err


def time_b2_and_dsm(name, power, mixed, dsm_terms, commits, b2_runs, b2_wall):
    """Phase 9: B2 and dsm against their bounds and plain versions, the
    aggregate verify split by stage, and the B2 path's commit times.
    Returns (B2 ms and plain ms at MIXED_LANES, dsm ms and plain ms at
    DSM_LANES)."""
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    tag = {"card": name, "power_limit": power}
    b2_ms = {}
    for lanes in TIME_LANES:
        args, _, _ = f32p.marshal_device_args((mixed * (lanes // len(mixed) + 1))[:lanes], DEVICE)
        b2_ms[lanes] = cuda_ms(lambda: b2.verify_lanes(*args))
        b_ms, b_by = bound_ms(b2, lanes)
        log({"phase": "b2_time", **tag, "lanes": lanes, "ms": b2_ms[lanes],
             "sigs_per_s": lanes / b2_ms[lanes] * 1e3, "bound_ms": b_ms, "bound_by": b_by})
    args, _, _ = f32p.marshal_device_args(mixed, DEVICE)
    b2_plain_ms = cuda_ms(lambda: b2.verify_plain(*args), reps=PLAIN_TIME_REPS, warmup=0)
    log({"phase": "b2_plain_time", **tag, "lanes": MIXED_LANES, "ms": b2_plain_ms})

    dsm_ms = {}
    for lanes in DSM_TIME_LANES:
        rows = ed32.marshal_dsm_args((dsm_terms * (lanes // len(dsm_terms) + 1))[:lanes], DEVICE)
        dsm_ms[lanes] = cuda_ms(lambda: ed32.dsm_lanes(*rows))
        b_ms, b_by = bound_ms(ed32, lanes)
        log({"phase": "dsm_time", **tag, "lanes": lanes, "ms": dsm_ms[lanes],
             "bound_ms": b_ms, "bound_by": b_by})
    rows = ed32.marshal_dsm_args(dsm_terms[:DSM_LANES], DEVICE)
    limbs = [ed32.limbs_from_bytes(r) for r in rows]
    dsm_plain_ms = cuda_ms(lambda: ed32.dsm_plain(*limbs), reps=PLAIN_TIME_REPS, warmup=0)
    log({"phase": "dsm_plain_time", **tag, "lanes": DSM_LANES, "ms": dsm_plain_ms})

    dv = gateway.default_verifier()
    for label in ("agg_100", "agg_400"):
        vs, bid, commit = commits[label]
        agg = AggregateCommit.from_commit(commit, CHAIN_ID, vs)
        agg_args = _aggregate_args(vs, agg)
        terms = ed25519_agg.aggregate_terms(*agg_args)
        points = ed32.dsm_batch(terms, DEVICE)
        rows = ed32.marshal_dsm_args(terms, DEVICE)
        log({"phase": "aggregate_time", **tag, "validators": vs.size(), "lanes": len(terms),
             "verify_commit_warm_best_of_3_s": min(
                 timed(lambda: vs.verify_commit(CHAIN_ID, bid, 1, agg)) for _ in range(3)),
             "aggregate_terms_host_s": min(
                 timed(lambda: ed25519_agg.aggregate_terms(*agg_args)) for _ in range(3)),
             "dsm_batch_s": min(timed(lambda: ed32.dsm_batch(terms, DEVICE)) for _ in range(3)),
             "dsm_kernel_s": cuda_ms(lambda: ed32.dsm_lanes(*rows)) / 1e3,
             "finish_from_points_host_s": min(
                 timed(lambda: ed25519_agg.finish_from_points(points)) for _ in range(3)),
             "stats": dv.stats()})

    for label, fn in b2_runs.items():
        log({"phase": "b2_commit_time", **tag, "commit": label, "first_s": b2_wall[label],
             "warm_best_of_3_s": min(timed(fn) for _ in range(3))})
    return b2_ms[MIXED_LANES], b2_plain_ms, dsm_ms[DSM_LANES], dsm_plain_ms


def shard_meshes() -> dict[str, list[str]]:
    """B1''s meshes: every visible card, and SHARDS shards over one."""
    import torch

    return {"cards": [f"cuda:{i}" for i in range(torch.cuda.device_count())],
            "one_card": ["cuda:0"] * SHARDS}


def check_sharded(shapes, whole) -> int:
    """Phase 10: B1' against the unsharded kernel and verify_plain, lane
    for lane, over both meshes, on the quorum batch and on every shape of
    phase 2 (whose B1 and plain lanes `whole` holds), so every shard
    geometry of phase 11 is compared; then dryrun_multichip over every
    card. Returns the largest difference."""
    import torch

    from tendermint_tpu_torch import multichip
    from tendermint_tpu_torch.ops import ed25519_f32 as f32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    quorum, forged_at = multichip.quorum_batch()
    args, _, _ = f32p.marshal_device_args(quorum, DEVICE)
    whole = {"quorum": {"b1": f32p.verify_lanes(*args).cpu(),
                        "plain": f32.verify_plain(args[0].float(), args[1].float(), args[2].float(),
                                                  args[3], args[4].int(), args[5].int())
                        .to(torch.int32).cpu()},
             **whole}
    meshes = {mname: f32p.ShardedVerify(mesh) for mname, mesh in shard_meshes().items()}
    max_err = 0
    for label, items in (("quorum", quorum), *shapes.items()):
        n = len(items)
        for mname, mesh in shard_meshes().items():
            t0 = time.perf_counter()
            res, valid_s, _ = f32p.sharded_verify_arrays(items, meshes[mname])
            got = res.wait()[:n].clone()
            errs = {k: int((got - w).abs().max().item()) for k, w in whole[label].items()}
            max_err = max(max_err, *errs.values())
            verdicts = f32p.materialize_verdicts(got, valid_s, n)
            lanes = {sz for _, sz in res.shards}
            log({"phase": "sharded_vs_b1_and_plain", "inputs": label, "mesh": mname,
                 "lanes": n, "layout": res.shards, "accepted": int(verdicts.sum()),
                 "max_abs_err": errs, "seconds": time.perf_counter() - t0})
            for k, w in whole[label].items():
                if errs[k] != 0:
                    bad = torch.nonzero(got != w).flatten()[:10].tolist()
                    raise AssertionError(f"{label} on {mname}: B1' disagrees with {k} at lanes {bad}")
            if [d for d, _ in res.shards] != mesh or len(lanes) != 1:
                raise AssertionError(f"{label} on {mname}: layout {res.shards}")
            rejected = tuple(int(i) for i in np.flatnonzero(~verdicts))
            if label == "quorum" and rejected != forged_at:
                raise AssertionError(f"quorum on {mname}: rejected {rejected[:10]}")
            if label not in ("quorum", "mixed") and rejected:
                raise AssertionError(f"{label} on {mname}: valid lanes rejected at {rejected[:10]}")
    multichip.dryrun_multichip(torch.cuda.device_count())
    return max_err


def make_mixed_commit(ed_validators, seed_of, rng):
    """A 100-validator commit whose set mixes len(ed_validators) ed25519
    keys with MIXED_SECP secp256k1 keys from the seed, made through the
    port's VoteSet. Returns (set, block id, commit)."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto.keys import SignatureEd25519, gen_priv_key_secp256k1
    from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote
    from tendermint_tpu_torch.types.vote_set import VoteSet

    secp = [gen_priv_key_secp256k1(rng.bytes(32)) for _ in range(MIXED_SECP)]
    vs = ValidatorSet(list(ed_validators) + [Validator.new(k.pub_key(), 10) for k in secp])
    secp_of = {k.pub_key().address(): k for k in secp}
    bid = BlockID(hashlib.sha256(b"mixed").digest()[:20],
                  PartSetHeader(1, hashlib.sha256(b"mixed-parts").digest()[:20]))
    votes = VoteSet(CHAIN_ID, 1, 0, VOTE_TYPE_PRECOMMIT, vs)
    for idx, v in enumerate(vs.validators):
        vote = Vote(v.address, idx, 1, 0, VOTE_TYPE_PRECOMMIT, bid)
        sb = vote.sign_bytes(CHAIN_ID)
        sig = (secp_of[v.address].sign(sb) if v.address in secp_of
               else SignatureEd25519(ed.sign(seed_of[v.address], sb)))
        if not votes.add_vote(vote.with_signature(sig)):
            raise AssertionError(f"mixed commit: vote {idx} was not added")
    return vs, bid, votes.make_commit()


def sharded_main_path(commits, forged, sub_quorum, mixed_commit) -> int:
    """Phase 11: the main path through a ShardedVerifier on SHARDS shards
    over cuda:0. Returns the B1 launches of the run."""
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops.gateway import ShardedVerifier

    v = ShardedVerifier(shard_meshes()["one_card"])
    vs100, bid100, c100 = commits["commit_small"]
    vs1000, group = commits["fast_sync_group"]
    vs10k, bid10k, c10k = commits["commit_large"]
    vs_mix, bid_mix, c_mix = mixed_commit
    primed = recorded_items(vs100, 1, bid100, c100)
    f32p.launches = b2.launches = ed32.launches = 0
    wall = {}
    wall["commit_large"] = timed(lambda: vs10k.verify_commit(
        CHAIN_ID, bid10k, 1, c10k, batch_verifier=v.commit_batch_verifier()))
    wall["fast_sync_group"] = timed(lambda: [f() for f in vs1000.verify_commits_async(
        CHAIN_ID, [(bid, h, c) for bid, c, h in group], v.verify_batch_async)])
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    v.prime_cache_async(primed)
    if not all(v.verify_one(*it) for it in primed):
        raise AssertionError("a primed valid signature was rejected")
    wall["commit_mixed"] = timed(lambda: vs_mix.verify_commit(
        CHAIN_ID, bid_mix, 1, c_mix, batch_verifier=v.commit_batch_verifier()))
    launches = {"b1": f32p.launches, "b2": b2.launches, "dsm": ed32.launches}
    stats = v.stats()
    log({"phase": "sharded_main_path", "mesh": [str(d) for d in v.mesh], "launches": launches,
         "stats": stats, "layout": v.last_shard_layout, "wall_s": wall, "refused": refusals})
    if launches != {"b1": SHARDS * 6, "b2": 0, "dsm": 0} or stats["tpu_batches"] != 6:
        raise AssertionError(f"expected 6 sharded batches of {SHARDS} B1 launches and no other "
                             f"launch: {launches}, {stats}")
    if stats["cpu_sigs"] != MIXED_SECP:
        raise AssertionError(f"expected exactly the {MIXED_SECP} secp256k1 lanes on the CPU: {stats}")
    if len(v.last_shard_layout) != SHARDS or len({sz for _, sz in v.last_shard_layout}) != 1:
        raise AssertionError(f"layout {v.last_shard_layout}")
    return launches["b1"]


def mesh_window_ms(sharded, shard_args, reps: int = 7, warmup: int = 2) -> float:
    """Median device time of one launch per shard, in a single window: a
    start event on the current stream, every shard stream waiting on it,
    the current stream waiting on every shard's end event, then the stop
    event."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    def window() -> float:
        cur = torch.cuda.current_stream()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(cur)
        for dev, stream, args in zip(sharded.devices, sharded.streams, shard_args):
            stream.wait_event(start)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                f32p.verify_lanes(*args)
                end = torch.cuda.Event()
                end.record(stream)
            cur.wait_event(end)
        stop.record(cur)
        stop.synchronize()
        return start.elapsed_time(stop)

    for _ in range(warmup):
        window()
    return statistics.median(window() for _ in range(reps))


def time_sharded(name, power, mixed, commits) -> float:
    """Phase 12: B1' on 1 and SHARDS shards over cuda:0 at 4096 and
    16,384 lanes, the host's time to issue one launch, the
    10,000-validator commit through Verifier and through ShardedVerifier
    on 1 and SHARDS shards, and the sharded dispatch of its lanes by
    stage. Returns the SHARDS-shard time at MIXED_LANES."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops.gateway import ShardedVerifier, Verifier

    tag = {"card": name, "power_limit": power}
    window = {}
    for lanes in (MIXED_LANES, TIME_LANES[-1]):
        planes, rs, _ = f32p.host_planes((mixed * (lanes // len(mixed) + 1))[:lanes], lanes)
        b_ms, b_by = bound_ms(f32p, lanes)
        for shards in (1, SHARDS):
            sharded = f32p.ShardedVerify(shard_meshes()["one_card"][:1] * shards)
            per = lanes // shards
            shard_args = [f32p.device_args(np.ascontiguousarray(planes[..., k * per:(k + 1) * per]),
                                           np.ascontiguousarray(rs[k * per:(k + 1) * per]),
                                           sharded.devices[k]) for k in range(shards)]
            window[lanes, shards] = mesh_window_ms(sharded, shard_args)
            log({"phase": "sharded_time", **tag, "lanes": lanes, "shards": shards,
                 "ms": window[lanes, shards], "sigs_per_s": lanes / window[lanes, shards] * 1e3,
                 "bound_ms": b_ms, "bound_by": b_by})
    torch.cuda.synchronize()
    # the host's cost of issuing one launch, which staggers the shards'
    # start inside the window
    args, _, _ = f32p.marshal_device_args(mixed, DEVICE)
    t0 = time.perf_counter()
    for _ in range(20):
        f32p.verify_lanes(*args)
    issue_s = (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    log({"phase": "launch_issue_time", **tag, "lanes": MIXED_LANES, "host_us_per_launch": issue_s * 1e6})

    vs10k, bid10k, c10k = commits["commit_large"]
    verifiers = {"verifier_b1": Verifier(device=DEVICE),
                 "sharded_verifier_1": ShardedVerifier(shard_meshes()["one_card"][:1]),
                 f"sharded_verifier_{SHARDS}": ShardedVerifier(shard_meshes()["one_card"])}
    best = {label: [] for label in verifiers}
    for _ in range(4):
        for label, ver in verifiers.items():
            best[label].append(timed(lambda: vs10k.verify_commit(
                CHAIN_ID, bid10k, 1, c10k, batch_verifier=ver.commit_batch_verifier())))
    log({"phase": "sharded_commit_time", **tag, "validators": vs10k.size(),
         "warm_best_of_4_s": {label: min(t) for label, t in best.items()}})

    # where the sharded dispatch of that commit's lanes goes, stage by stage
    large = recorded_items(vs10k, 1, bid10k, c10k)
    sharded = f32p.ShardedVerify(shard_meshes()["one_card"])
    bucket = -(-len(large) // f32p.lane_quantum(SHARDS)) * f32p.lane_quantum(SHARDS)
    planes, rs, _ = f32p.host_planes(large, bucket)
    stages = {"host_planes_s": [], "dispatch_s": [], "wait_s": []}
    for _ in range(3):
        stages["host_planes_s"].append(timed(lambda: f32p.host_planes(large, bucket)))
        t0 = time.perf_counter()
        res = sharded.dispatch(planes, rs)
        stages["dispatch_s"].append(time.perf_counter() - t0)
        stages["wait_s"].append(timed(res.wait))
    log({"phase": "sharded_dispatch_breakdown", **tag, "lanes": len(large), "bucket": bucket,
         "shards": SHARDS, **{k: min(t) for k, t in stages.items()},
         "b1_marshal_and_copy_s": min(timed(lambda: f32p.marshal_device_args(large, DEVICE))
                                      for _ in range(3))})
    return window[MIXED_LANES, SHARDS]


# -- phases 13 to 17: the comb path (B4) and the torch compositions (B3, B5) ---


def key_rows(pubs):
    """(k, 32) uint8 canonical affine x and y rows of compressed keys
    (native batch decompression)."""
    from tendermint_tpu_torch.ops import ed25519_f32 as f32

    xs, ys, ok = f32._decompress_rows([bytes(p) for p in pubs])
    if not ok.all():
        raise AssertionError("a validator key did not decompress")
    return xs, ys


def comb_key_rows(pubs):
    """(32, k) uint8 canonical affine rows of Q = -A, as CombPool.ensure
    hands them to the table build."""
    from tendermint_tpu_torch.ops import ed25519_comb as comb

    xs, ys = key_rows(pubs)
    qx = np.stack([np.frombuffer(comb._neg_x_bytes(x.tobytes()), dtype=np.uint8) for x in xs], axis=1)
    return np.ascontiguousarray(qx), np.ascontiguousarray(ys.T)


def niels_reference(pub: bytes) -> np.ndarray:
    """A key's (1024, 96) comb table from the pure-Python group law: entry
    v of position p is v * 16^p * (-A) in niels form."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519_comb as comb

    x, y = _affine(ed.point_decompress(pub))
    gp = ((-x) % ed.P, y, 1, (-x) * y % ed.P)
    rows = np.zeros((comb.W_POS, comb.W_ENT, comb.COORD_ROWS), dtype=np.uint8)
    for p in range(comb.W_POS):
        rows[p, 0, 0] = rows[p, 0, 32] = 1
        acc = gp
        for v in range(1, comb.W_ENT):
            rows[p, v] = comb._niels_rows_np(*_affine(acc)).astype(np.uint8)
            acc = ed.point_add(acc, gp)
        for _ in range(4):
            gp = ed.point_add(gp, gp)
    return rows.reshape(-1, comb.COORD_ROWS)


def comb_lane_args(pool, items):
    """Lease (building tables where needed) and marshal items for the comb
    kernel: (the kernel's args after the tables, valid, slots)."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    n = len(items)
    planes, rs, valid = f32p.host_planes(items, n)
    slots = np.zeros(n, dtype=np.int32)
    vidx = np.flatnonzero(valid)
    if len(vidx):
        slots[vidx], _ = pool.ensure([items[i][0] for i in vidx], planes[0].T[vidx], planes[1].T[vidx])
    with pool.on_stream():
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                for a in (slots, planes[2], rs, planes[3], planes[4])]
    torch.cuda.synchronize()
    return args, valid, slots, planes


def check_comb(shapes, whole, pubs, rng):
    """Phase 13: both comb kernels against their plain versions. Returns
    (the pool holding every validator's table, the largest difference per
    kernel)."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    err = {"ed25519_comb_tables": 0, "ed25519_comb": 0}
    # the tables of 1 to 1000 keys (two 32-position blocks a key), bytes
    # exactly, slot 0 untouched; the plain version once over the most keys
    # (a key's table depends on the key only)
    qx, qy = comb_key_rows(pubs[:max(COMB_RAGGED_KEYS)])
    plain_rows = comb.build_tables_plain(torch.from_numpy(qx).to(DEVICE).float(),
                                         torch.from_numpy(qy).to(DEVICE).float()).to(torch.uint8)
    for k in COMB_RAGGED_KEYS:
        pool = torch.zeros(((k + 1) * comb.ROWS_PER_SLOT, comb.COORD_ROWS), dtype=torch.uint8, device=DEVICE)
        kx, ky = (torch.from_numpy(np.ascontiguousarray(a[:, :k])).to(DEVICE) for a in (qx, qy))
        comb.build_lanes(pool, kx, ky, torch.arange(1, k + 1, dtype=torch.int32, device=DEVICE))
        want = plain_rows[:k]
        got = pool.view(k + 1, comb.ROWS_PER_SLOT, comb.COORD_ROWS)
        torch.cuda.synchronize()
        e = int((got[1:].int() - want.int()).abs().max().item())
        err["ed25519_comb_tables"] = max(err["ed25519_comb_tables"], e, int(got[0].int().abs().max().item()))
        log({"phase": "comb_tables_vs_plain", "keys": k, "max_abs_err": e, "slot0_zero": not got[0].any().item()})
        if err["ed25519_comb_tables"]:
            bad = torch.nonzero((got[1:] != want).any(dim=(1, 2))).flatten()[:10].tolist()
            raise AssertionError(f"table kernel disagrees with build_tables_plain at {k} keys: keys {bad} "
                                 "(or slot 0 written)")
        del pool, want, got
    del plain_rows

    # every validator's table in one launch, in the pool the verdicts use
    cpool = comb.CombPool(capacity=len(pubs) + 128, max_capacity=len(pubs) + 128, device=DEVICE)
    t0 = time.perf_counter()
    leased, _ = cpool.ensure(list(pubs), *key_rows(pubs))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rows = cpool._pool.view(-1, comb.ROWS_PER_SLOT, comb.COORD_ROWS)
    sample = rng.choice(len(pubs), size=8, replace=False)
    equal = [torch.equal(rows[int(leased[j])], torch.from_numpy(niels_reference(pubs[j])).to(DEVICE))
             for j in sample]
    log({"phase": "comb_tables_vs_reference", "keys": len(pubs), "sampled": [int(j) for j in sample],
         "equal": equal, "ensure_and_build_s": build_s, "stats": cpool.stats})
    if not all(equal):
        raise AssertionError("the 10,000-key table build disagrees with the pure-Python niels table")
    # and every one of its tables byte for byte the plain version's, in
    # chunks the plain version's intermediates fit
    qx, qy = comb_key_rows(pubs)
    slot_of = torch.from_numpy(np.asarray(leased, dtype=np.int64)).to(DEVICE)
    e = 0
    for lo in range(0, len(pubs), COMB_PLAIN_CHUNK):
        hi = min(lo + COMB_PLAIN_CHUNK, len(pubs))
        want = comb.build_tables_plain(*(torch.from_numpy(np.ascontiguousarray(a[:, lo:hi])).to(DEVICE).float()
                                         for a in (qx, qy))).to(torch.uint8)
        e = max(e, int((rows[slot_of[lo:hi]].int() - want.int()).abs().max().item()))
        del want
    err["ed25519_comb_tables"] = max(err["ed25519_comb_tables"], e)
    log({"phase": "comb_tables_vs_plain", "keys": len(pubs), "max_abs_err": e})
    if e:
        raise AssertionError(f"the {len(pubs)}-key table build disagrees with build_tables_plain")

    # verdicts: every phase-2 lane set and the ragged counts
    cases = [(label, items, whole[label]["b1"]) for label, items in shapes.items()]
    cases += [(f"ragged_{n}", shapes["mixed"][:n], whole["mixed"]["b1"][:n]) for n in RAGGED_LANES]
    for label, items, b1_raw in cases:
        n = len(items)
        args, valid, _, _ = comb_lane_args(cpool, items)
        t0 = time.perf_counter()
        with cpool.on_stream():
            got = comb.comb_lanes(cpool._pool, cpool.table_b(), *args)
            plain = comb.verify_comb_plain(cpool._pool, cpool.table_b(), args[0], args[1].float(),
                                           args[2], args[3].int(), args[4].int()).to(torch.int32)
        torch.cuda.synchronize()
        e = int((got - plain).abs().max().item()) if n else 0
        err["ed25519_comb"] = max(err["ed25519_comb"], e)
        verdicts = f32p.materialize_verdicts(got.cpu(), valid, n)
        b1 = f32p.materialize_verdicts(b1_raw, valid, n)
        log({"phase": "comb_vs_plain_and_b1", "shape": label, "lanes": n, "accepted": int(verdicts.sum()),
             "max_abs_err": e, "b1_disagree": int((verdicts != b1).sum()),
             "seconds": time.perf_counter() - t0})
        if e:
            bad = torch.nonzero(got != plain).flatten()[:10].tolist()
            raise AssertionError(f"{label}: comb kernel disagrees with verify_comb_plain at lanes {bad}")
        if (verdicts != b1).any():
            raise AssertionError(f"{label}: comb verdicts disagree with B1's at {np.flatnonzero(verdicts != b1)[:10]}")
        if label in ("commit_small", "fast_sync_group", "commit_large") and not verdicts.all():
            raise AssertionError(f"{label}: comb rejected a valid commit signature")
    return cpool, err


def comb_expected(keys, seen: dict, built: set) -> dict:
    """The launches one comb batch of these lanes' keys makes under the
    second-sight policy (MIN_SIGHT 2), updating `seen` and `built` as the
    module does: B1 for lanes whose key has no table and is seen for the
    first time, comb for the rest, one table-build launch if any of their
    keys has no table yet."""
    for k in set(keys):
        seen[k] = seen.get(k, 0) + 1
    comb_keys = {k for k in keys if k in built or seen[k] >= 2}
    new = comb_keys - built
    built |= comb_keys
    return {"b1": int(any(k not in comb_keys for k in keys)), "comb": int(bool(comb_keys)),
            "tables": int(bool(new)), "new_keys": len(new)}


def comb_main_path(name, power, commits, forged, sub_quorum) -> dict[str, int]:
    """Phase 14: the phase-3 commits through a Verifier built under
    TENDERMINT_TPU_KERNEL=comb, each twice after reset_default_pool(),
    then the refused commits. Returns the launches of each comb kernel."""
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops.gateway import Verifier

    v = verifier_under("comb", lambda: Verifier(device=DEVICE))
    vs100, bid100, c100 = commits["commit_small"]
    vs1000, group = commits["fast_sync_group"]
    vs10k, bid10k, c10k = commits["commit_large"]
    runs = {
        "commit_small": lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, c100, batch_verifier=v.commit_batch_verifier()),
        "fast_sync_group": lambda: [f() for f in vs1000.verify_commits_async(
            CHAIN_ID, [(bid, h, c) for bid, c, h in group], v.verify_batch_async)],
        "commit_large": lambda: vs10k.verify_commit(
            CHAIN_ID, bid10k, 1, c10k, batch_verifier=v.commit_batch_verifier()),
    }
    keys_of = {"commit_small": [vs100.get_by_index(i)[1].pub_key.raw for i in range(vs100.size())],
               "fast_sync_group": [vs1000.get_by_index(i)[1].pub_key.raw for i in range(vs1000.size())],
               "commit_large": [vs10k.get_by_index(i)[1].pub_key.raw for i in range(vs10k.size())]}
    comb.reset_default_pool()
    seen, built, passes, wall = {}, set(), [], {}

    def counts():
        return {"b1": f32p.launches, "comb": comb.launches, "tables": comb.table_launches,
                "b2": b2.launches, "dsm": ed32.launches}

    f32p.launches = b2.launches = ed32.launches = comb.launches = comb.table_launches = 0
    for label, fn in runs.items():
        for rep in (1, 2):
            want = comb_expected(keys_of[label], seen, built)
            before = counts()
            wall[label, rep] = timed(fn)
            got = {k: counts()[k] - before[k] for k in before}
            passes.append({"commit": label, "pass": rep, "launches": got, "expected": want,
                           "wall_s": wall[label, rep]})
            if got != {"b1": want["b1"], "comb": want["comb"], "tables": want["tables"], "b2": 0, "dsm": 0}:
                raise AssertionError(f"{label} pass {rep}: launches {got}, expected {want}")
            if rep == 2 and got["b1"]:
                raise AssertionError(f"{label}: a second pass launched B1")
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    launches = counts()
    stats, pool = v.stats(), comb.default_pool(DEVICE)
    log({"phase": "comb_main_path", "kernel": v.kernel, "passes": passes, "launches": launches,
         "stats": stats, "pool": pool.stats, "capacity": pool.capacity, "refused": refusals})
    if launches != {"b1": 3, "comb": 7, "tables": 3, "b2": 0, "dsm": 0}:
        raise AssertionError(f"expected 3 B1, 7 comb and 3 table-build launches: {launches}")
    if pool.stats["build_keys"] != len(keys_of["commit_large"]) or stats["cpu_sigs"] != 0:
        raise AssertionError(f"expected one table a distinct key and no CPU lane: {pool.stats}, {stats}")
    # where a warm comb commit's host time goes, stage by stage (every key
    # has its table): the sight counts, the marshal, the leases, the launch
    large = recorded_items(vs10k, 1, bid10k, c10k)
    keys = [it[0] for it in large]
    planes, rs, _ = f32p.host_planes(large, len(large))
    xs, ys = planes[0].T, planes[1].T
    slots, _ = pool.ensure(keys, xs, ys)
    log({"phase": "comb_commit_breakdown", "card": name, "power_limit": power, "lanes": len(large),
         "structural_and_tally_s": min(timed(lambda: recorded_items(vs10k, 1, bid10k, c10k))
                                       for _ in range(3)),
         "bump_seen_s": min(timed(lambda: comb._bump_seen(set(keys))) for _ in range(3)),
         "host_planes_s": min(timed(lambda: f32p.host_planes(large, len(large))) for _ in range(3)),
         "ensure_s": min(timed(lambda: pool.ensure(keys, xs, ys)) for _ in range(3)),
         "launch_and_resolve_s": min(timed(lambda: pool.launch(slots, planes, rs)()) for _ in range(3)),
         "verify_batch_s": min(timed(lambda: comb.verify_batch(large, DEVICE)) for _ in range(3))})
    for label, fn in runs.items():
        log({"phase": "comb_commit_time", "card": name, "power_limit": power, "commit": label, "first_pass_s": wall[label, 1],
             "second_pass_s": wall[label, 2], "warm_best_of_3_s": min(timed(fn) for _ in range(3))})
    return {"ed25519_comb": launches["comb"], "ed25519_comb_tables": launches["tables"]}


def verifier_under(kernel: str, make):
    """make(), a Verifier, built under TENDERMINT_TPU_KERNEL=kernel (the
    knob is read once, at construction) and checked to run that kernel."""
    before = os.environ.get("TENDERMINT_TPU_KERNEL")
    os.environ["TENDERMINT_TPU_KERNEL"] = kernel
    try:
        v = make()
    finally:
        if before is None:
            del os.environ["TENDERMINT_TPU_KERNEL"]
        else:
            os.environ["TENDERMINT_TPU_KERNEL"] = before
    if v.kernel != kernel:
        raise AssertionError(f"TENDERMINT_TPU_KERNEL={kernel} built a {v.kernel} verifier")
    return v


def comb_small_pool(commits) -> None:
    """Phase 15: a SMALL_POOL-slot pool as the card's default pool, after
    phase 14 has seen every key twice, through SMALL_POOL_BATCHES: evictions,
    a batch of more keys than the pool holds (PoolExhausted: B1, no comb
    launch), then evicted keys again (rebuilt). Every verdict must be
    right."""
    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    vs100, bid100, c100 = commits["commit_small"]
    items = recorded_items(vs100, 1, bid100, c100)
    pool = comb.CombPool(capacity=SMALL_POOL, max_capacity=SMALL_POOL, device=DEVICE)
    comb.set_default_pool(pool)
    steps = []
    (a_lo, a_hi), (b_lo, b_hi), _, _ = SMALL_POOL_BATCHES
    min_evictions = (b_hi - a_hi) - (SMALL_POOL - 1 - (a_hi - a_lo))
    for (lo, hi), want in zip(SMALL_POOL_BATCHES, ((0, 1, 1), (0, 1, 1), (1, 0, 0), (0, 1, 1))):
        label = f"keys {lo}-{hi - 1}"
        before = (f32p.launches, comb.launches, comb.table_launches)
        ok = comb.verify_batch(items[lo:hi], DEVICE)
        got = tuple(a - b for a, b in zip((f32p.launches, comb.launches, comb.table_launches), before))
        steps.append({"batch": label, "launches_b1_comb_tables": got, "stats": dict(pool.stats),
                      "all_accepted": bool(ok.all())})
        if got != want or not ok.all():
            raise AssertionError(f"small pool, {label}: launches {got} (expected {want}), "
                                 f"accepted {int(ok.sum())} of {hi - lo}")
    log({"phase": "comb_small_pool", "slots": SMALL_POOL, "steps": steps})
    if pool.stats["evictions"] < min_evictions or pool.stats["grows"]:
        raise AssertionError(f"expected evictions and no growth: {pool.stats}")
    comb.reset_default_pool()


def registry_compositions(name, power, commits, mixed) -> None:
    """Phase 16: the 100-validator commit under f32 and int32 and through
    a 4-shard f32 ShardedVerifier (torch compositions: no kernel
    launches), a first and a warm run each (2-4 s a run: per-op bound);
    f32's, int32's and decompress_batch's outputs on the card against the
    reference and the CPU."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32 as f32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops.gateway import ShardedVerifier, Verifier

    tag = {"card": name, "power_limit": power}
    vs100, bid100, c100 = commits["commit_small"]
    sample = mixed[:256]
    ref = [ed.verify(*it) for it in sample]
    for label, module in (("f32", f32), ("int32", ed32)):
        if list(module.verify_batch(sample, DEVICE)) != ref:
            raise AssertionError(f"{label} on the card disagrees with crypto.ed25519.verify")
    keys = [vs100.get_by_index(i)[1].pub_key.raw for i in range(vs100.size())] + [b"\xff" * 32]
    for a, b in zip(ed32.decompress_batch(keys, DEVICE), ed32.decompress_batch(keys, "cpu")):
        if not np.array_equal(a, b):
            raise AssertionError("int32 decompress_batch on the card disagrees with the CPU")
    log({"phase": "composition_time", **tag, "keys": len(keys), "lanes": len(mixed),
         "decompress_batch_s": min(timed(lambda: ed32.decompress_batch(keys, DEVICE)) for _ in range(3)),
         "decompress_bound_ms": 1e3 * DECOMPRESS_PRODUCTS_PER_KEY * len(keys) / INT_MUL_PER_S,
         "f32_verify_batch_s": timed(lambda: f32.verify_batch(mixed, DEVICE)),
         "int32_verify_batch_s": timed(lambda: ed32.verify_batch(mixed, DEVICE))})

    for label, v in (("f32", verifier_under("f32", lambda: Verifier(device=DEVICE))),
                     ("int32", verifier_under("int32", lambda: Verifier(device=DEVICE))),
                     (f"sharded_f32_{SHARDS}",
                      verifier_under("f32", lambda: ShardedVerifier(shard_meshes()["one_card"])))):
        f32p.launches = b2.launches = ed32.launches = comb.launches = comb.table_launches = 0
        run = lambda: vs100.verify_commit(  # noqa: E731
            CHAIN_ID, bid100, 1, c100, batch_verifier=v.commit_batch_verifier())
        first = timed(run)
        launches = {"b1": f32p.launches, "b2": b2.launches, "dsm": ed32.launches,
                    "comb": comb.launches, "tables": comb.table_launches}
        stats = v.stats()
        log({"phase": "composition_path", **tag, "kernel": label, "validators": vs100.size(),
             "launches": launches, "stats": stats, "layout": getattr(v, "last_shard_layout", None),
             "first_s": first, "warm_s": timed(run)})
        if any(launches.values()) or stats["tpu_batches"] != 1 or stats["cpu_sigs"]:
            raise AssertionError(f"{label}: expected one device batch and no kernel: {launches}, {stats}")


def comb_bound_ms(pool, args, lanes: int) -> tuple[float, float]:
    """The comb verify's least time on these inputs, by operations (its
    limb products over the multiply rate) and by bytes (the distinct table
    rows its lanes gather, the lane arguments and the verdicts over the
    memory rate); the bound is the larger."""
    from tendermint_tpu_torch.ops import ed25519_comb as comb

    slots, ry, rs, s8, h8 = (a.cpu().numpy() for a in args)
    pos = np.arange(comb.W_POS)[:, None]

    def digits(b8):
        return np.stack([b8 & 15, b8 >> 4], axis=1).reshape(comb.W_POS, -1).astype(np.int64)

    rows_a = np.unique((slots[None, :].astype(np.int64) * comb.W_POS + pos) * comb.W_ENT + digits(h8))
    rows_b = np.unique(pos * comb.W_ENT + digits(s8))
    moved = (len(rows_a) + len(rows_b)) * comb.COORD_ROWS + lanes * (3 * 32 + 3 * 4)
    return 1e3 * comb.PRODUCTS_PER_LANE * lanes / INT_MUL_PER_S, 1e3 * moved / HBM_BYTES_PER_S


def larger(ops_ms: float, bytes_ms: float) -> tuple[float, str]:
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def time_comb(name, power, pool, shapes, group_items, pubs) -> dict[str, dict]:
    """Phase 17: the comb kernel at TIME_LANES lanes of commit signatures
    (the 10,000-validator commit's, then the fast-sync group's: one key a
    lane, every table in `pool`), the table build at COMB_TABLE_KEYS keys,
    and both plain versions. Returns the kernels line's numbers per
    kernel."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_comb as comb

    tag = {"card": name, "power_limit": power}
    lanes_src = (shapes["commit_large"] + group_items) * 2
    out = {}
    for lanes in TIME_LANES:
        args, _, _, _ = comb_lane_args(pool, lanes_src[:lanes])
        with pool.on_stream():
            ms = cuda_ms(lambda: comb.comb_lanes(pool._pool, pool.table_b(), *args))
        ops_ms, bytes_ms = comb_bound_ms(pool, args, lanes)
        b_ms, b_by = larger(ops_ms, bytes_ms)
        log({"phase": "comb_time", **tag, "lanes": lanes, "ms": ms, "sigs_per_s": lanes / ms * 1e3,
             "bound_ms": b_ms, "bound_by": b_by, "ops_ms": ops_ms, "bytes_ms": bytes_ms})
        if lanes == MIXED_LANES:
            with pool.on_stream():
                plain_ms = cuda_ms(lambda: comb.verify_comb_plain(
                    pool._pool, pool.table_b(), args[0], args[1].float(), args[2], args[3].int(),
                    args[4].int()), reps=PLAIN_TIME_REPS, warmup=0)
            log({"phase": "comb_plain_time", **tag, "lanes": lanes, "ms": plain_ms})
            out["ed25519_comb"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                   "lanes": lanes}

    qx, qy = comb_key_rows(pubs[: max(COMB_TABLE_KEYS)])
    for keys in COMB_TABLE_KEYS:
        rows = torch.zeros(((keys + 1) * comb.ROWS_PER_SLOT, comb.COORD_ROWS), dtype=torch.uint8,
                           device=DEVICE)
        kx, ky = (torch.from_numpy(np.ascontiguousarray(a[:, :keys])).to(DEVICE) for a in (qx, qy))
        slots = torch.arange(1, keys + 1, dtype=torch.int32, device=DEVICE)
        ms = cuda_ms(lambda: comb.build_lanes(rows, kx, ky, slots), reps=5, warmup=1)
        ops_ms = 1e3 * comb.PRODUCTS_PER_KEY * keys / INT_MUL_PER_S
        bytes_ms = 1e3 * comb.BYTES_PER_KEY * keys / HBM_BYTES_PER_S
        b_ms, b_by = larger(ops_ms, bytes_ms)
        # the kernel's own products (one inversion a position) at the same rate
        kernel_ops_ms = 1e3 * comb.KERNEL_PRODUCTS_PER_KEY * keys / INT_MUL_PER_S
        log({"phase": "comb_tables_time", **tag, "keys": keys, "ms": ms, "keys_per_s": keys / ms * 1e3,
             "bound_ms": b_ms, "bound_by": b_by, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
             "kernel_ops_ms": kernel_ops_ms})
        if keys == COMB_JSON_KEYS:
            plain_ms = cuda_ms(lambda: comb.build_tables_plain(kx.float(), ky.float()), reps=PLAIN_TIME_REPS, warmup=0)
            log({"phase": "comb_tables_plain_time", **tag, "keys": keys, "ms": plain_ms})
            out["ed25519_comb_tables"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                          "bound_by": b_by, "keys": keys}
        del rows
    torch.cuda.synchronize()
    return out


# -- phases 18 to 20: the hash plane (B6) -------------------------------------

_M32 = 0xFFFFFFFF


def hash_messages(rng, n: int) -> list[bytes]:
    """n messages: HASH_EDGE_LENGTHS first (from 7 messages on every batch
    holds the block-count edges, from 9 on a 10,240-byte transaction and a
    64 KB part), then random lengths up to 2,000 bytes."""
    lengths = list(HASH_EDGE_LENGTHS) + [int(x) for x in rng.integers(0, 2001, size=n)]
    return [rng.bytes(k) for k in lengths[:n]]


def check_hash_kernels(rng) -> tuple[dict[str, int], dict[str, float]]:
    """Phase 18: K1 and K2 at HASH_COUNTS messages against their plain
    versions (run once, on the card, over the widest batch's messages of at
    most PLAIN_MAX_BLOCKS blocks: a lane's digest depends on its own
    message only) and every lane, the 10,240- and 65,536-byte ones too,
    against crypto.hashing.ripemd160 / hashlib.sha256; K3 at TREE_LEAVES
    leaves against `_run_tree` on the card and FlatTree.from_leaf_digests,
    slot for slot. Returns the largest difference a kernel and the plain
    versions' seconds over their batch."""
    import torch

    from tendermint_tpu_torch.crypto.hashing import ripemd160
    from tendermint_tpu_torch.merkle.simple import FlatTree, leaf_hash
    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops import merkle as tm

    msgs = hash_messages(rng, max(HASH_COUNTS))
    short = [i for i, m in enumerate(msgs) if (len(m) + 72) // 64 <= PLAIN_MAX_BLOCKS]
    row_of = {i: r for r, i in enumerate(short)}
    errs, plain_s = {}, {}
    for kname, le, lanes, plain, to_bytes, ref in (
            ("ripemd160", True, th.ripemd160_lanes, th.ripemd160_words, th.digests_to_bytes_le,
             ripemd160),
            ("sha256", False, th.sha256_lanes, th.sha256_words, th.digests_to_bytes_be,
             lambda m: hashlib.sha256(m).digest())):
        args = th.to_device(*th.pack_ragged([msgs[i] for i in short], le), DEVICE)
        t0 = time.perf_counter()
        want = plain(*args)
        torch.cuda.synchronize()
        plain_s[kname] = time.perf_counter() - t0
        log({"phase": "hash_plain_run", "kernel": kname, "messages": len(short),
             "max_blocks": int(args[2].max().item()), "seconds": plain_s[kname]})
        refs = [ref(m) for m in msgs]
        errs[kname] = 0
        for c in HASH_COUNTS:
            got = lanes(*th.to_device(*th.pack_ragged(msgs[:c], le), DEVICE))
            idx = [i for i in short if i < c]
            rows = torch.tensor([row_of[i] for i in idx], device=got.device)
            err = int(((got[torch.tensor(idx, device=got.device)].long() & _M32) - want[rows]).abs().max().item())
            equal_ref = to_bytes(got) == refs[:c]
            log({"phase": "hash_vs_plain", "kernel": kname, "messages": c,
                 "lengths": sorted({len(m) for m in msgs[:c]} & set(HASH_EDGE_LENGTHS)),
                 "plain_lanes": len(idx), "max_abs_err": err, "equal_reference": equal_ref})
            if err or not equal_ref:
                raise AssertionError(f"{kname} at {c} messages disagrees with its plain version "
                                     f"({err}) or the reference ({equal_ref})")
            errs[kname] = max(errs[kname], err)
    errs["merkle_tree"] = 0
    for n in TREE_LEAVES:
        digests = [leaf_hash(b"leaf-%d" % i) for i in range(n)]
        nodes = tm._digest_rows(digests, torch.device(DEVICE))
        left, right, out, _, _, _, rounds = tm._dense_schedule(n)
        sched = [torch.from_numpy(a).long().to(DEVICE) for a in (left, right, out)]
        want = tm._run_tree(nodes.long() & _M32, *sched, rounds)[: 2 * n - 1]
        got = tm.tree_lanes(nodes, n)[: 2 * n - 1]
        err = int(((got.long() & _M32) - want).abs().max().item())
        equal_flat = th.digests_to_bytes_le(got) == FlatTree.from_leaf_digests(digests).nodes
        log({"phase": "merkle_vs_plain", "leaves": n, "rounds": rounds, "max_width": left.shape[1],
             "max_abs_err": err, "equal_flat_tree": equal_flat})
        if err or not equal_flat:
            raise AssertionError(f"merkle_tree at {n} leaves disagrees with its plain version "
                                 f"({err}) or FlatTree ({equal_flat})")
    torch.cuda.synchronize()
    return errs, plain_s


def make_block_txs(rng):
    """({label: txs}, ConsensusParams): `block_1mb`, BASELINE.json's 1 MB
    block of 64 KB parts (BLOCK_1MB_TXS transactions of BLOCK_1MB_TX_BYTES),
    and `block_cap`, types/params.py's caps: max_txs transactions of 1 to
    4,096 bytes, every 1,000th at the tx cap of 10,240."""
    from tendermint_tpu_torch.types.params import ConsensusParams

    params = ConsensusParams()
    raw = rng.bytes(BLOCK_1MB_TXS * BLOCK_1MB_TX_BYTES)
    small = [raw[i * BLOCK_1MB_TX_BYTES:(i + 1) * BLOCK_1MB_TX_BYTES] for i in range(BLOCK_1MB_TXS)]
    lengths = rng.integers(1, 4097, size=params.block_size.max_txs)
    lengths[999::1000] = params.tx_size.max_bytes
    buf = rng.bytes(int(lengths.sum()))
    ends = np.cumsum(lengths)
    cap = [buf[e - k:e] for e, k in zip(ends.tolist(), lengths.tolist())]
    return {"block_1mb": small, "block_cap": cap}, params


def host_hasher():
    """A Hasher built under TENDERMINT_TPU_HASHES=0: the operator's host
    floor (the native library and hashlib), no device."""
    from tendermint_tpu_torch.ops.gateway import Hasher

    before = os.environ.get("TENDERMINT_TPU_HASHES")
    os.environ["TENDERMINT_TPU_HASHES"] = "0"
    try:
        h = Hasher()
    finally:
        if before is None:
            del os.environ["TENDERMINT_TPU_HASHES"]
        else:
            os.environ["TENDERMINT_TPU_HASHES"] = before
    if h.device is not None:
        raise AssertionError("TENDERMINT_TPU_HASHES=0 built a device Hasher")
    return h


def make_block_with(h, txs, commit_args, part_size, height=2, app_hash=APP_HASH,
                    time_ns=BLOCK_TIME_NS):
    """Block.make_block wired to h as consensus wires its Hasher
    (consensus/state.py:944-959): the tx root through set_batch_tx_root,
    the part set through the part hashers and the tree submitter.
    `commit_args` is (the height's validator set, the last block's ID,
    the LastCommit)."""
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.block import Block

    vs, bid, commit = commit_args
    ptx.set_batch_tx_root(h.tx_merkle_root)
    return Block.make_block(
        height, CHAIN_ID, txs, commit, bid, vs.hash(), app_hash, part_size, time_ns=time_ns,
        part_hasher=h.part_leaf_hashes, part_tree_hasher=h.part_set_tree,
        part_tree_submitter=h.submit_part_set_tree,
    )


def reset_launches() -> None:
    import importlib

    from tendermint_tpu_torch.ops import kernels

    for module, attr in kernels.LAUNCH_COUNTERS.values():
        setattr(importlib.import_module(module), attr, 0)


def read_launches() -> dict[str, int]:
    from tendermint_tpu_torch.ops import kernels

    return kernels.launch_counts()


class capture_hash_calls:
    """Inside the block, record every K1 / K2 / K3 wrapper call: the kernel,
    the block it serves, its inputs as passed (copied before the launch)
    and its output (copied after), on the caller's stream. The wrappers
    still launch and count; the copies cost a few device copies a call."""

    def __init__(self, calls: list, label: str):
        self.calls, self.label = calls, label

    def __enter__(self):
        from tendermint_tpu_torch.ops import hashing as th
        from tendermint_tpu_torch.ops import merkle as tm

        self.real = (th.ripemd160_lanes, th.sha256_lanes, tm.tree_lanes)
        calls, label = self.calls, self.label

        def hashes(kname, wrapper):
            def spy(words, first, nblocks, out=None):
                args = (words.clone(), first.clone(), nblocks.clone())
                got = wrapper(words, first, nblocks, out=out)
                calls.append({"kernel": kname, "block": label, "args": args, "got": got.clone()})
                return got
            return spy

        def tree(nodes, n):
            before = nodes.clone()
            got = self.real[2](nodes, n)
            calls.append({"kernel": "merkle_tree", "block": label, "leaves": n, "args": before,
                          "got": got.clone()})
            return got

        th.ripemd160_lanes = hashes("ripemd160", self.real[0])
        th.sha256_lanes = hashes("sha256", self.real[1])
        tm.tree_lanes = tree
        return self

    def __exit__(self, *exc):
        from tendermint_tpu_torch.ops import hashing as th
        from tendermint_tpu_torch.ops import merkle as tm

        th.ripemd160_lanes, th.sha256_lanes, tm.tree_lanes = self.real
        return False


def unpack_lanes(words, first, nblocks, little_endian: bool) -> list[bytes]:
    """The messages of a packed K1 / K2 batch, read back from their
    MD padding: each lane's blocks end in its length in bits."""
    raw = words.cpu().numpy().astype("<u4" if little_endian else ">u4").tobytes()
    order = "little" if little_endian else "big"
    out = []
    for f, n in zip(first.tolist(), nblocks.tolist()):
        lane = raw[64 * f:64 * (f + n)]
        out.append(lane[:int.from_bytes(lane[-8:], order) // 8])
    return out


def check_path_kernels(calls, block_txs) -> dict[str, int]:
    """Phase 19's kernel calls against their plain versions on the card, on
    the main path's own inputs as recorded: the K1 lanes (tx leaves and
    parts of both blocks) and K2's of at most PLAIN_MAX_BLOCKS blocks in
    one plain walk a kernel, every longer lane (the 64 KB parts, the longer
    transactions) against the host's digest of its message, read back from
    the recorded words; each K3 tree against `_run_tree`. Labels each
    call's batch (tx_leaves, parts, txs, tx_tree, part_tree) for phase 20
    and returns the largest difference a kernel."""
    import torch

    from tendermint_tpu_torch.crypto.hashing import ripemd160
    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops import merkle as tm

    want_calls = {"ripemd160": 2 * len(block_txs), "sha256": 1, "merkle_tree": 2 * len(block_txs)}
    got_calls = {k: sum(c["kernel"] == k for c in calls) for k in want_calls}
    if got_calls != want_calls:
        raise AssertionError(f"recorded kernel calls {got_calls}, expected {want_calls}")
    errs = {}
    for kname, plain, le, to_bytes, ref in (
            ("ripemd160", th.ripemd160_words, True, th.digests_to_bytes_le, ripemd160),
            ("sha256", th.sha256_words, False, th.digests_to_bytes_be, lambda m: hashlib.sha256(m).digest())):
        mine = [c for c in calls if c["kernel"] == kname]
        rows, nbs, gots, host_err = [], [], [], {}
        for c in mine:
            words, first, nblocks = c["args"]
            keep = nblocks <= PLAIN_MAX_BLOCKS
            for f, n in zip(first[keep].tolist(), nblocks[keep].tolist()):
                rows.append(words[f:f + n])
            nbs.append(nblocks[keep])
            gots.append(c["got"][keep])
            far = torch.nonzero(~keep).flatten()
            msgs = unpack_lanes(words, first[far], nblocks[far], le)
            host_err[id(c)] = (len(msgs), sum(a != ref(m) for a, m in zip(to_bytes(c["got"][far]), msgs)))
        nblocks = torch.cat(nbs)
        firsts = torch.zeros_like(nblocks)
        firsts[1:] = torch.cumsum(nblocks, 0)[:-1]
        t0 = time.perf_counter()
        want = plain(torch.cat(rows), firsts, nblocks) if rows else None
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = torch.cat(gots).long() & _M32
        errs[kname], lo = 0, 0
        for c, g in zip(mine, gots):
            n_all, n = c["args"][1].shape[0], g.shape[0]
            c["batch"] = ("txs" if kname == "sha256"
                          else "tx_leaves" if n_all == len(block_txs[c["block"]]) else "parts")
            err = int((got[lo:lo + n] - want[lo:lo + n]).abs().max().item()) if n else 0
            n_host, host_bad = host_err[id(c)]
            log({"phase": "path_vs_plain", "kernel": kname, "block": c["block"], "batch": c["batch"],
                 "messages": n_all, "max_blocks": int(c["args"][2].max().item()), "plain_lanes": n,
                 "max_abs_err": err, "host_digest_lanes": n_host, "host_digest_mismatches": host_bad,
                 "plain_walk_s": seconds})
            errs[kname] = max(errs[kname], err, host_bad)
            lo += n
    errs["merkle_tree"] = 0
    for c in calls:
        if c["kernel"] != "merkle_tree":
            continue
        n = c["leaves"]
        c["batch"] = "tx_tree" if n == len(block_txs[c["block"]]) else "part_tree"
        left, right, out, _, _, _, rounds = tm._dense_schedule(n)
        sched = [torch.from_numpy(a).long().to(DEVICE) for a in (left, right, out)]
        want = tm._run_tree(c["args"].long() & _M32, *sched, rounds)[: 2 * n - 1]
        err = int(((c["got"][: 2 * n - 1].long() & _M32) - want).abs().max().item())
        log({"phase": "path_vs_plain", "kernel": "merkle_tree", "block": c["block"],
             "batch": c["batch"], "leaves": n, "rounds": rounds, "max_abs_err": err})
        errs["merkle_tree"] = max(errs["merkle_tree"], err)
    if any(errs.values()):
        raise AssertionError(f"the main path's kernel calls disagree with their plain versions: {errs}")
    return errs


def hash_main_path(commit_args, block_txs, params):
    """Phase 19: each block built through `Block.make_block` with a fresh
    Hasher on the card, its launches reset just before and read just after
    (K1 twice, tx leaves and part leaves; K3 once a tree; nothing else),
    its stats checked, and the block held against the same block built on
    the host floor (bytes, header, data and part-set hashes, every proof),
    through its own bytes, and through a PartSet filled part by part (a
    flipped byte refused). Then K2's path, its entry point
    `ops.hashing.sha256_batch` on block_1mb's transactions. Every kernel
    call on the card is recorded (`capture_hash_calls`). Returns the
    launches a kernel over these paths, per block its objects and the
    builds' wall seconds, and the recorded calls."""
    import torch

    from tendermint_tpu_torch.crypto import hashing as crypto_hashing
    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops.gateway import Hasher
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.block import Block
    from tendermint_tpu_torch.types.part_set import InvalidProofError, Part, PartSet

    part_size = params.block_gossip.block_part_size_bytes
    total = {"ripemd160": 0, "sha256": 0, "merkle_tree": 0}
    built, calls = {}, []
    for label, txs in block_txs.items():
        h = Hasher()
        with capture_hash_calls(calls, label):
            reset_launches()
            t0 = time.perf_counter()
            block, ps = make_block_with(h, txs, commit_args, part_size)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        stats = h.stats()
        data = block.to_bytes()
        if len(txs) > params.block_size.max_txs or len(data) > params.block_size.max_bytes:
            raise AssertionError(f"{label}: {len(txs)} txs, {len(data)} bytes: over the caps")
        want = {"ripemd160": 2, "sha256": 0, "merkle_tree": 2, "b1": 0, "b2": 0, "dsm": 0,
                "comb": 0, "tables": 0}
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, expected {want}")
        got_stats = {k: stats[k] for k in ("tpu_part_batches", "tpu_tx_roots", "cpu_leaves",
                                           "submitted_jobs")}
        if got_stats != {"tpu_part_batches": 1, "tpu_tx_roots": 1, "cpu_leaves": 0, "submitted_jobs": 1}:
            raise AssertionError(f"{label}: Hasher stats {stats}")
        for k in total:
            total[k] += launches[k]

        h_host = host_hasher()
        t0 = time.perf_counter()
        ref, ref_ps = make_block_with(h_host, txs, commit_args, part_size)
        wall_host = time.perf_counter() - t0
        same = {
            "bytes": data == ref.to_bytes(),
            "header_hash": block.hash() == ref.hash() != b"",
            "data_hash": block.header.data_hash == ref.header.data_hash,
            "part_set_header": ps.header() == ref_ps.header(),
            "proofs": all(ps.get_part(i).proof == ref_ps.get_part(i).proof for i in range(ps.total)),
        }
        ptx.set_batch_tx_root(h.tx_merkle_root)
        same["from_bytes"] = Block.from_bytes(data).hash() == block.hash()
        fresh = PartSet.from_header(ps.header())
        same["parts_accepted"] = all(fresh.add_part(Part.from_json(ps.get_part(i).to_json()))
                                     for i in range(ps.total))
        same["reassembled"] = fresh.is_complete() and fresh.get_data() == data
        part = ps.get_part(ps.total // 2)
        flipped = bytearray(part.bytes_)
        flipped[len(flipped) // 3] ^= 0x10
        try:
            PartSet.from_header(ps.header()).add_part(Part(part.index, bytes(flipped), part.proof))
            same["flipped_refused"] = False
        except InvalidProofError:
            same["flipped_refused"] = True
        log({"phase": "hash_main_path", "block": label, "txs": len(txs), "bytes": len(data),
             "parts": ps.total, "launches": launches, "stats": stats, "checks": same,
             "wall_s": wall, "host_floor_wall_s": wall_host,
             "hashlib_ripemd160": crypto_hashing._RIPEMD_TEMPLATE is not None})
        if not all(same.values()):
            raise AssertionError(f"{label}: {same}")
        built[label] = {"block": block, "data": data, "parts": ps.total, "wall_s": wall,
                        "host_wall_s": wall_host}
    ptx.set_batch_tx_root(None)

    # K2's path: no block path hashes with SHA-256 (nor in the JAX
    # package); its entry point on block_1mb's transactions
    msgs = block_txs["block_1mb"]
    with capture_hash_calls(calls, "block_1mb"):
        reset_launches()
        digests = th.sha256_batch(msgs)
        launches = read_launches()
    ok = digests == [hashlib.sha256(m).digest() for m in msgs]
    log({"phase": "sha256_entry_point", "messages": len(msgs), "launches": launches, "equal_hashlib": ok})
    if not ok or launches["sha256"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"sha256_batch: {launches}, equal to hashlib: {ok}")
    total["sha256"] = launches["sha256"]
    return total, built, calls


def alu_yardsticks(name: str, power: str) -> dict[str, float]:
    """Phase 20's yardsticks, from imad_rate.cu's ALU probes: the card's
    rate of the hash kernels' instruction mix (LOP3, IADD3, SHF.L.W),
    swept over chains a thread and blocks an SM, each loop's SASS counted;
    and one dependent instruction's latency, one thread on one chain, in
    SM cycles (clock64) and in ns (CUDA events)."""
    import re

    import torch

    from tendermint_tpu_torch.ops import kernels

    lib_path = os.path.join(kernels.BUILD_DIR, f"lib{PROBE}.so")
    sass = sass_counts(lib_path)
    loops = {}
    for f, c in sass.items():
        m = re.search(r"alu_rate_kernelILi(\d+)E", f)
        if m and "longest_loop" in c:
            loops[int(m.group(1))] = c["longest_loop"]
        if "alu_chain_kernel" in f and "longest_loop" in c:
            loops["chain"] = c["longest_loop"]
    lib = kernels.load(PROBE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, per_sm_steps = 256, 1 << 28
    out = torch.empty(8 * sms * threads, dtype=torch.int64, device=DEVICE)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    sweep, rate = [], 0.0
    for chains in (8, 16, 32):
        loop = loops[chains]
        alu_per_iter = sum(loop[op] for op in ("LOP3", "IADD3", "SHF"))
        for per_sm in (2, 4, 8):
            blocks = per_sm * sms
            iters = per_sm_steps // (per_sm * threads * chains)

            def launch() -> None:
                rc = lib.tm_imad_rate(2, chains, out.data_ptr(), iters, blocks, threads, stream())
                if rc != 0:
                    raise RuntimeError(f"alu_rate launch failed: cudaError {rc}")

            r = blocks * threads * iters * alu_per_iter / (cuda_ms(launch) / 1e3)
            sweep.append({"chains": chains, "blocks_per_sm": per_sm, "alu_per_s": r})
            rate = max(rate, r)
    chain = loops["chain"]
    iadd_on_chain = chain["IADD3"] - 1 if chain["IADD3"] > chain["LOP3"] else chain["IADD3"]
    per_iter = chain["LOP3"] + chain["SHF"] + iadd_on_chain
    iters = 50_000

    def launch_chain() -> None:
        rc = lib.tm_imad_rate(3, 1, out.data_ptr(), iters, 1, 1, stream())
        if rc != 0:
            raise RuntimeError(f"alu_chain launch failed: cudaError {rc}")

    chain_ms = cuda_ms(launch_chain, reps=5)
    cycles = int(out[1].item())
    yard = {"alu_per_s": rate, "dep_ns": chain_ms * 1e6 / (iters * per_iter),
            "dep_cycles": cycles / (iters * per_iter)}
    log({"phase": "alu_rate", "card": name, "power_limit": power, "sms": sms, "threads": threads,
         "loop_sass": {str(k): v for k, v in loops.items()}, "chain_instructions_per_iter": per_iter,
         "sweep": sweep, **yard})
    return yard


def compression_loops(sass: dict, function: str, marks: dict[str, str]) -> dict:
    """The SASS of one compression in a hash kernel, whose warps each run a
    part of it in a loop of their own: the loop of each part by its marks
    (RMD_LINE_MARKS: K1's and K3's RIPEMD-160 lines, each loop holding its
    line's exchange, join and loads; SHA_WARP_MARKS: K2's rounds and
    schedule, each loop holding its warp's shared loads or stores and its
    barrier), the parts' instructions summed over their distinct loops
    (one loop when a branch on the warp keeps both parts in it)."""
    c = next(c for f, c in sass.items() if function in f)
    parts = {k: v for k, v in c.get("marked_loops", {}).items() if k in marks}
    if set(parts) != set(marks):
        raise AssertionError(f"{function}: no loop holds each of {sorted(marks)} ({sorted(parts)})")
    distinct = {(v["start"], v["end"]): v for v in parts.values()}
    return {"instructions": sum(v["instructions"] for v in distinct.values()),
            "loops": len(distinct), "per_part": parts}


def hash_bound(yard, compressions: int, chain_blocks: int, chain: int, instrs: int,
               moved_bytes: int) -> dict:
    """The least time of a hash batch: the largest of (a) its compressions'
    SASS instructions over the measured ALU rate, (b) its bytes over the
    memory rate, (c) its longest serial chain (blocks in sequence x the
    compression's dependent instructions) at the measured dependent
    latency. bound_by is "bytes" for (b) and "operations" for (a) and (c);
    bound_term names the term."""
    terms = {
        "issue": 1e3 * compressions * instrs / yard["alu_per_s"],
        "bytes": 1e3 * moved_bytes / HBM_BYTES_PER_S,
        "chain": 1e-6 * chain_blocks * chain * yard["dep_ns"],
    }
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, **{f"{k}_ms": v for k, v in terms.items()}}


def time_hashes(name, power, commit_args, block_txs, built, calls, params, plain_18_s) -> list[dict]:
    """Phase 20: K1 on both blocks' part batches and tx-leaf batches, K2 on
    the tx-leaf batches, K3 on phase 19's recorded trees (their own leaf
    digests), each with its bound and the native host library's time on
    the same input; the plain versions where a run is short (block_1mb's
    tx leaves, the trees), their results held against the kernel's; the
    make_block wall time through the card's Hasher and through the host
    floor (a fresh Hasher each run: no tx-root cache), and where a card
    build's time goes. Returns the kernels line's entries."""
    import torch

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.codec.binary import encode_bytes
    from tendermint_tpu_torch.merkle.simple import FlatTree
    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.ops import merkle as tm
    from tendermint_tpu_torch.ops.gateway import Hasher
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.part_set import PartSet

    tag = {"card": name, "power_limit": power}
    yard = alu_yardsticks(name, power)
    hash_sass = sass_counts(os.path.join(kernels.BUILD_DIR, "libhash_blocks.so"),
                            {**RMD_LINE_MARKS, **SHA_WARP_MARKS})
    tree_sass = sass_counts(os.path.join(kernels.BUILD_DIR, "libmerkle_tree.so"), RMD_LINE_MARKS)
    per_block = {"ripemd160": compression_loops(hash_sass, "hash_blocks_kernelILi0E", RMD_LINE_MARKS),
                 "sha256": compression_loops(hash_sass, "hash_blocks_kernelILi1E", SHA_WARP_MARKS)}
    per_node = compression_loops(tree_sass, "merkle_tree_kernel", RMD_LINE_MARKS)
    log({"phase": "hash_sass", "per_block_loop": per_block, "per_node_loop": per_node,
         "functions": {"hash_blocks": hash_sass, "merkle_tree": tree_sass}})
    chains = {"ripemd160": th.RIPEMD160_CHAIN, "sha256": th.SHA256_CHAIN}
    width = {"ripemd160": 20, "sha256": 32}
    best3 = lambda fn: 1e3 * min(timed(fn) for _ in range(3))  # noqa: E731
    part_size = params.block_gossip.block_part_size_bytes
    json_shape = {}

    def time_batch(kname, label, batch, msgs, native_fn, plain=False):
        le = kname == "ripemd160"
        words, first, nblocks = th.pack_ragged(msgs, le)
        args = th.to_device(words, first, nblocks, DEVICE)
        lanes = th.ripemd160_lanes if le else th.sha256_lanes
        ms = cuda_ms(lambda: lanes(*args))
        dev_ms = device_ms(lambda: lanes(*args), "hash_blocks_kernel")
        moved = 64 * len(words) + 8 * len(msgs) + width[kname] * len(msgs)
        b = hash_bound(yard, len(words), int(nblocks.max()), chains[kname],
                       per_block[kname]["instructions"], moved)
        row = {"phase": "hash_time", **tag, "kernel": kname, "block": label, "batch": batch,
               "messages": len(msgs), "bytes": sum(map(len, msgs)), "compressions": len(words),
               "max_blocks": int(nblocks.max()), "ms": ms, "device_ms": dev_ms, **b,
               "native_ms": best3(native_fn)}
        if plain:
            fn = th.ripemd160_words if le else th.sha256_words
            row["plain_ms"] = cuda_ms(lambda: fn(*args), reps=PLAIN_TIME_REPS, warmup=0)
            got = lanes(*args).long() & _M32
            row["max_abs_err"] = int((got - fn(*args)).abs().max().item())
            if row["max_abs_err"]:
                raise AssertionError(f"{kname} on {label}'s {batch} disagrees with its plain version")
        log(row)
        if (label, batch) == HASH_JSON_BATCH:
            json_shape[kname] = row

    for label, txs in block_txs.items():
        data = built[label]["data"]
        chunks = [data[i:i + part_size] for i in range(0, len(data), part_size)]
        time_batch("ripemd160", label, "parts", chunks, lambda: native.ripemd160_batch(chunks))
        leaves = [encode_bytes(t) for t in txs]
        first = label == "block_1mb"
        time_batch("ripemd160", label, "tx_leaves", leaves, lambda: native.merkle_leaf_hashes(txs),
                   plain=first)
        time_batch("sha256", label, "tx_leaves", leaves, lambda: native.sha256_batch(leaves),
                   plain=first)

    # K3 on the main path's own trees: each recorded call's node buffer,
    # its leaf digests filled
    for c in calls:
        if c["kernel"] != "merkle_tree":
            continue
        n, filled = c["leaves"], c["args"]
        nodes = filled.clone()
        digests = th.digests_to_bytes_le(filled[:n])
        ms = cuda_ms(lambda: tm.tree_lanes(nodes, n))
        dev_ms = device_ms(lambda: tm.tree_lanes(nodes, n), "merkle_tree_kernel")
        left, right, out, _, _, _, rounds = tm._dense_schedule(n)
        sched = [torch.from_numpy(a).long().to(DEVICE) for a in (left, right, out)]
        plain_nodes = filled.long() & _M32
        moved = 20 * n + 12 * (n - 1) + 4 * rounds + 20 * (n - 1)
        b = hash_bound(yard, n - 1, rounds, th.RIPEMD160_CHAIN, per_node["instructions"], moved)
        want = tm._run_tree(plain_nodes, *sched, rounds)[: 2 * n - 1]
        err = int(((nodes[: 2 * n - 1].long() & _M32) - want).abs().max().item())
        if err:
            raise AssertionError(f"merkle_tree on {c['block']}'s {c['batch']} disagrees with its plain version")
        row = {"phase": "merkle_time", **tag, "block": c["block"], "batch": c["batch"], "leaves": n,
               "rounds": rounds, "ms": ms, "device_ms": dev_ms, **b,
               "plain_ms": cuda_ms(lambda: tm._run_tree(plain_nodes, *sched, rounds), reps=PLAIN_TIME_REPS, warmup=0),
               "max_abs_err": err,
               "native_root_ms": best3(lambda: native.merkle_root_from_leaf_digests(digests)),
               "host_flat_tree_ms": best3(lambda: FlatTree.from_leaf_digests(digests))}
        log(row)
        if (c["block"], c["batch"]) == TREE_JSON_BATCH:
            json_shape["merkle_tree"] = row

    for label, txs in block_txs.items():
        block = built[label]["block"]
        walls = {}
        for kind, make in (("card", Hasher), ("host_floor", host_hasher)):
            runs = []
            for _ in range(3):
                h = make()
                t0 = time.perf_counter()
                make_block_with(h, txs, commit_args, part_size)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            walls[kind] = min(runs)
        # where a card build's time goes, stage by stage (each timed alone)
        h = Hasher()
        leaves = [encode_bytes(t) for t in txs]
        packed = th.pack_ragged(leaves, True)
        stages = {
            "tx_encode_s": min(timed(lambda: [encode_bytes(t) for t in txs]) for _ in range(3)),
            "tx_pack_s": min(timed(lambda: th.pack_ragged(leaves, True)) for _ in range(3)),
            "tx_copy_s": min(timed(lambda: (th.to_device(*packed, DEVICE), torch.cuda.synchronize()))
                             for _ in range(3)),
            "tx_root_s": min(timed(lambda: Hasher().tx_merkle_root(txs)) for _ in range(3)),
            "to_bytes_s": min(timed(block.to_bytes) for _ in range(3)),
            "part_set_s": min(timed(lambda: PartSet.from_data(
                built[label]["data"], part_size, tree_submitter=h.submit_part_set_tree)) for _ in range(3)),
        }
        log({"phase": "make_block_time", **tag, "block": label, "txs": len(txs),
             "bytes": len(built[label]["data"]), "parts": built[label]["parts"],
             "first_card_s": built[label]["wall_s"], "first_host_floor_s": built[label]["host_wall_s"],
             "card_best_of_3_s": walls["card"], "host_floor_best_of_3_s": walls["host_floor"],
             "card_stages": stages})
    ptx.set_batch_tx_root(None)

    entries = []
    for kname in ("ripemd160", "sha256", "merkle_tree"):
        row = json_shape[kname]
        shape = {"block": row["block"], "batch": row["batch"],
                 **({"leaves": row["leaves"]} if kname == "merkle_tree" else {"messages": row["messages"]})}
        entries.append({"name": kname, "ms": row["ms"], "device_ms": row["device_ms"],
                        "plain_ms": row["plain_ms"], "max_abs_err": row["max_abs_err"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "bound_term": row["bound_term"], "library_ms": None,
                        "native_ms": row.get("native_ms", row.get("native_root_ms")), **shape,
                        "plain_phase18_s": plain_18_s.get(kname)})
    return entries


# -- phases 21 and 22: the device daemon ---------------------------------------


class DaemonOnCard:
    """`python3 -m tendermint_tpu_torch.devd` on the card, on a socket in a
    short directory under /tmp, with SIGTERM honoured and the kernel left
    to its claim-time bake-off unless `knobs` pins it (the daemon's
    TENDERMINT_DEVD_* settings). `stop()` sends the shutdown op and kills
    the process if it is still alive after DEVD_STOP_S."""

    def __init__(self, knobs: dict | None = None):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
        self.sock = os.path.join(self.dir, "devd.sock")
        self.log_path = os.path.join(self.dir, "devd.log")
        root = os.path.dirname(os.path.abspath(__file__))
        env = {k: v for k, v in os.environ.items() if k not in (
            "TENDERMINT_TPU_KERNEL", "TENDERMINT_DEVD_KERNEL", "TENDERMINT_DEVD_CHUNK",
            "TENDERMINT_DEVD_ACCEPT_CPU", "TENDERMINT_DEVD_SIM_RATE", "TENDERMINT_DEVD_SOCKS",
            "TENDERMINT_DEVD_WARM")}
        env.update(TENDERMINT_DEVD_SOCK=self.sock, TENDERMINT_DEVD_EXIT_ON_TERM="1",
                   PYTHONPATH=os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p))
        env.update(knobs or {})
        self.log = open(self.log_path, "wb")
        self.started = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch.devd"], env=env,
                                     cwd=root, stdout=subprocess.DEVNULL, stderr=self.log)

    def log_text(self) -> str:
        self.log.flush()
        with open(self.log_path, "rb") as f:
            return f.read().decode(errors="replace")

    def wait_held(self) -> float:
        """Seconds from the start to `ping` reporting the card held."""
        from tendermint_tpu_torch import devd

        client = devd.DevdClient(self.sock, connect_timeout=1.0, io_timeout=10.0)
        deadline = self.started + DEVD_HELD_S
        try:
            while time.perf_counter() < deadline:
                if self.proc.poll() is not None:
                    break
                try:
                    if client.ping(timeout=2.0).get("held"):
                        return time.perf_counter() - self.started
                except (OSError, devd.DevdError):
                    pass
                time.sleep(0.5)
        finally:
            client.close()
        raise AssertionError(f"devd not serving after {time.perf_counter() - self.started:.0f} s "
                             f"(exit {self.proc.poll()}):\n{self.log_text()[-4000:]}")

    def launches(self, client) -> dict[str, int]:
        """The daemon's kernel launch counts, from the line its `stats` op
        writes to its log."""
        client.stats()
        for _ in range(50):
            got = last_launch_line(self.log_text())
            if got is not None:
                return got
            time.sleep(0.1)
        raise AssertionError("devd logged no kernel launches")

    def stop(self) -> None:
        from tendermint_tpu_torch import devd

        if self.proc.poll() is None:
            client = devd.DevdClient(self.sock, connect_timeout=1.0, io_timeout=5.0)
            try:
                client.shutdown()
            except (OSError, devd.DevdError, EOFError):
                pass
            finally:
                client.close()
            try:
                self.proc.wait(timeout=DEVD_STOP_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=DEVD_STOP_S)
        self.log.close()


def claim_log(text: str) -> dict:
    """The claim's numbers from the daemon's log: build seconds, each
    bake-off candidate's pipelined rate, the kernel served, the chunk
    width and the claim's seconds."""
    import re

    out: dict = {"bake_off_sigs_per_s": {}, "chunk_sigs_per_s": {}}
    for line in text.splitlines():
        if m := re.search(r"kernels built in ([0-9.]+)s", line):
            out["build_s"] = float(m.group(1))
        elif m := re.search(r"serving kernel: (\w+) \(bake-off (.*)\)$", line):
            out["kernel"] = m.group(1)
            out["bake_off_sigs_per_s"] = json.loads(m.group(2))
        elif m := re.search(r"chunk (\d+): ([0-9.]+) sigs/s pipelined", line):
            out["chunk_sigs_per_s"][int(m.group(1))] = float(m.group(2))
        elif m := re.search(r"stream chunk width: (\d+)", line):
            out["chunk"] = int(m.group(1))
        elif m := re.search(r"device held \((.*)\) in ([0-9.]+)s of claim", line):
            out["held"], out["claim_s"] = m.group(1), float(m.group(2))
    return out


class routed_to:
    """Inside the block this process's gateway routes to the daemon at the
    one socket given (TENDERMINT_DEVD_SOCK), or to the fleet of several
    (TENDERMINT_DEVD_SOCKS), or with none given to no daemon at all (the
    local route), with TENDERMINT_TPU_KERNEL unset and the
    backend's client, the fleet's endpoints, the probe cache and the
    breakers fresh. All are put back after."""

    KEYS = ("TENDERMINT_DEVD_SOCK", "TENDERMINT_DEVD_SOCKS", "TENDERMINT_TPU_KERNEL")

    def __init__(self, *socks: str):
        self.socks = socks

    def _fresh(self) -> None:
        from tendermint_tpu_torch import devd
        from tendermint_tpu_torch.ops import devd_backend, devd_shard, gateway

        if devd_backend._client is not None:
            devd_backend._client.close()
        devd_backend._client = None
        devd_backend.reset_stream_latches()
        devd_shard.reset()
        devd.bust_avail_cache()
        gateway.reset_devd_breaker()
        gateway._rtt_cache.clear()

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        for k in self.KEYS:
            os.environ.pop(k, None)
        if len(self.socks) == 1:
            os.environ["TENDERMINT_DEVD_SOCK"] = self.socks[0]
        elif self.socks:
            os.environ["TENDERMINT_DEVD_SOCKS"] = ",".join(self.socks)
        self._fresh()
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self._fresh()
        return False


def devd_phase(name, power, commits, forged, sub_quorum, shapes, block_txs, params) -> dict:
    """Phases 21 and 22: the device daemon on the card. Start it, route a
    default Verifier and Hasher through it, and hold every result against
    the same call in process: the commits' verdicts lane for lane against
    B1's, a 10,000-lane verify_stream, the agg op's points against the dsm
    kernel's, block_cap's parts and tree through hash_stream against the
    in-process K1 and K3, and both blocks against the host floor. The
    daemon's counts must show every lane on the card, its kernels'
    launches each path's kernels, and the breaker CLOSED throughout.
    Returns the daemon's launches a kernel over the phase, phase 22's warm
    times through it and the chunk width it chose."""
    import shutil

    tag = {"card": name, "power_limit": power}
    daemon = DaemonOnCard()
    try:
        held_s = daemon.wait_held()
        claim = claim_log(daemon.log_text())
        log({"phase": "devd_claim", **tag, "held_after_s": held_s, **claim})
        if claim.get("kernel") not in ("comb", "f32p") or set(claim["bake_off_sigs_per_s"]) != {"comb", "f32p"}:
            raise AssertionError(f"devd bake-off: {claim}")
        with routed_to(daemon.sock):
            return _devd_paths(daemon, tag, claim, commits, forged, sub_quorum, shapes, block_txs, params)
    finally:
        daemon.stop()
        log({"phase": "devd_stopped", "exit": daemon.proc.returncode})
        shutil.rmtree(daemon.dir, ignore_errors=True)


def _devd_paths(daemon, tag, claim, commits, forged, sub_quorum, shapes, block_txs, params) -> dict:
    import threading

    from tendermint_tpu_torch import devd
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops import merkle as ops_merkle
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    client = devd.DevdClient(daemon.sock)
    if gateway.kernel_name() != "devd":
        raise AssertionError(f"kernel_name() is {gateway.kernel_name()!r} beside a serving daemon")
    v = gateway.Verifier()
    local = gateway.Verifier(device=DEVICE)
    if v.kernel != "devd" or v.device is not None:
        raise AssertionError(f"default Verifier: kernel {v.kernel}, device {v.device}")
    vs100, bid100, c100 = commits["commit_small"]
    vs1000, group = commits["fast_sync_group"]
    vs10k, bid10k, c10k = commits["commit_large"]
    part_size = params.block_gossip.block_part_size_bytes
    agg = AggregateCommit.from_commit(c100, CHAIN_ID, vs100)
    idxs = agg.signers.indices()
    terms = ed25519_agg.aggregate_terms([vs100.get_by_index(i)[1].pub_key.raw for i in idxs],
                                        [agg.sign_message(CHAIN_ID)] * len(idxs), agg.rs, agg.s_agg)
    big = shapes["commit_large"]

    hashers = {}

    def block_path(label, h, route):
        hashers[label, route] = h
        out = make_block_with(h, block_txs[label], commits["commit_small"], part_size)
        ptx.set_batch_tx_root(None)
        return out

    # each path: (through the daemon, the same call in process)
    paths = {
        "commit_small": [lambda ver=ver: vs100.verify_commit(
            CHAIN_ID, bid100, 1, c100, batch_verifier=ver.commit_batch_verifier()) for ver in (v, local)],
        "fast_sync_group": [lambda ver=ver: [f() for f in vs1000.verify_commits_async(
            CHAIN_ID, [(bid, h, c) for bid, c, h in group], ver.verify_batch_async)] for ver in (v, local)],
        "commit_large": [lambda ver=ver: vs10k.verify_commit(
            CHAIN_ID, bid10k, 1, c10k, batch_verifier=ver.commit_batch_verifier()) for ver in (v, local)],
        "verify_stream_10k": [lambda: client.verify_stream(big),
                              lambda: [bool(b) for b in f32p.verify_batch(big, DEVICE)]],
        "agg_100": [lambda ver=ver: agg.verify(CHAIN_ID, vs100, agg_verifier=ver.verify_aggregate)
                    for ver in (v, local)],
        **{f"make_block_{label}": [lambda label=label: block_path(label, gateway.Hasher(), "devd"),
                                   lambda label=label: block_path(label, gateway.Hasher(device=DEVICE), "local")]
           for label in block_txs},
    }

    # -- phase 21: the paths through the daemon, its counts read before and after
    stats0, status0 = client.stats(), client.status()
    launches0 = daemon.launches(client)
    first, first_local, out = {}, {}, {}
    for label, (through, here) in paths.items():
        t0 = time.perf_counter()
        out[label] = through()
        first[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out[label, "local"] = here()
        first_local[label] = time.perf_counter() - t0
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    # the commits' lanes again, each verdict against B1's in process
    lane_sets = {**{k: shapes[k] for k in ("commit_small", "fast_sync_group", "commit_large")},
                 "forged": recorded_items(vs100, 1, bid100, forged)}
    differ, alone = {}, {}
    for label, items in lane_sets.items():
        got = v.verify_batch(items)
        want = [bool(b) for b in f32p.verify_batch(items, DEVICE)]
        differ[label] = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        alone[label] = want
        if want.count(False) != (1 if label == "forged" else 0):
            raise AssertionError(f"{label}: B1 refused {want.count(False)} lanes")
    streamed = out["verify_stream_10k"]
    differ["verify_stream_10k"] = (sum(a != b for a, b in zip(streamed, out["verify_stream_10k", "local"]))
                                   + abs(len(streamed) - len(big)))
    points = client.agg_batch(terms)
    alone["agg_100"] = ed32.dsm_batch(terms, DEVICE)
    differ["agg_100_points"] = sum(a != b for a, b in zip(points, alone["agg_100"])) + abs(len(points) - len(terms))
    hashed = {}
    for label in block_txs:
        block, ps = out[f"make_block_{label}"]
        h = hashers[label, "devd"]
        if h._route != "devd":
            raise AssertionError(f"default Hasher route {h._route!r} beside a serving daemon")
        ref, ref_ps = block_path(label, host_hasher(), "host")
        same = (block.to_bytes() == ref.to_bytes() and ps.header() == ref_ps.header()
                and all(ps.get_part(i).proof == ref_ps.get_part(i).proof for i in range(ps.total)))
        stats = h.stats()
        hashed[label] = {"parts": ps.total, "host_floor_equal": same,
                         **{k: stats[k] for k in ("tpu_part_batches", "tpu_tx_roots", "cpu_leaves",
                                                  "breaker_state")}}
        if hashed[label] != {"parts": ps.total, "host_floor_equal": True, "tpu_part_batches": 1,
                             "tpu_tx_roots": 1, "cpu_leaves": 0, "breaker_state": 0}:
            raise AssertionError(f"{label} through devd: {hashed[label]}")
    data = out["make_block_block_cap"][0].to_bytes()
    parts = [data[i:i + part_size] for i in range(0, len(data), part_size)]
    n_bytes = sum(map(len, parts))
    t0 = time.perf_counter()
    digests, nodes = client.hash_stream(parts, mode="part", tree=True, chunk=8)
    first["hash_stream_parts"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    alone["parts"] = ops_merkle.part_set_nodes(parts, DEVICE)
    first_local["hash_stream_parts"] = time.perf_counter() - t0
    want_digests, want_nodes = alone["parts"]
    differ["block_cap_parts"] = (sum(a != b for a, b in zip(digests, want_digests))
                                 + sum(a != b for a, b in zip(nodes, want_nodes[len(parts):]))
                                 + abs(len(digests) - len(parts)) + abs(len(nodes) - (len(parts) - 1)))
    # several clients at once, a connection and a daemon thread each, the
    # daemon's one Verifier and hasher shared: each gets what it got alone
    jobs = {
        "verify_stream_10k": lambda c: c.verify_stream(big),
        "fast_sync_group": lambda c: c.verify_batch(lane_sets["fast_sync_group"]),
        "agg_100": lambda c: c.agg_batch(terms),
        "parts": lambda c: c.hash_stream(parts, mode="part", tree=True, chunk=8),
    }
    want_jobs = {"verify_stream_10k": alone["commit_large"], "fast_sync_group": alone["fast_sync_group"],
                 "agg_100": alone["agg_100"], "parts": (want_digests, want_nodes[len(parts):])}
    got_jobs, errors = {}, []

    def run(label):
        c = devd.DevdClient(daemon.sock)
        try:
            got_jobs[label] = jobs[label](c)
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(f"{label}: {exc!r}")
        finally:
            c.close()

    threads = [threading.Thread(target=run, args=(label,)) for label in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent devd clients: {errors}")
    differ["concurrent"] = sum(got_jobs[k] != w for k, w in want_jobs.items())

    launches1 = daemon.launches(client)
    stats1, status1 = client.stats(), client.status()
    launches = {k: launches1[k] - launches0[k] for k in launches1}
    mine = v.stats()
    sent = mine["tpu_sigs"] + 2 * len(big) + len(lane_sets["fast_sync_group"])
    grew = {k: stats1[k] - stats0[k] for k in ("tpu_sigs", "cpu_sigs")}
    stream_grew = {k: status1["stream"][k] - status0["stream"][k] for k in ("streams", "chunks", "lanes")}
    hash_grew = {k: status1["hash_stream"][k] - status0["hash_stream"][k]
                 for k in ("streams", "chunks", "lanes", "trees")}
    breakers = gateway.devd_breaker_states()
    log({"phase": "devd_path", **tag, "kernel": claim["kernel"], "launches": launches,
         "verifier_stats": mine, "daemon_grew": grew, "stream_grew": stream_grew,
         "hash_stream_grew": hash_grew, "lanes_sent": sent, "differ": differ, "hashed": hashed,
         "breakers": breakers, "refused": refusals})
    if any(differ.values()):
        raise AssertionError(f"devd results differ from the in-process kernels: {differ}")
    if grew["tpu_sigs"] != sent or grew["cpu_sigs"] != 0 or mine["cpu_sigs"] != 0 \
            or mine["agg_lanes_cpu"] != 0:
        raise AssertionError(f"devd lanes: sent {sent}, daemon grew {grew}, verifier {mine}")
    if set(breakers.values()) != {gateway.CircuitBreaker.CLOSED} or mine["breaker_state"] != 0:
        raise AssertionError(f"devd breakers {breakers}")
    # two blocks (a tx tree and a part tree each) and the parts twice
    if stream_grew["chunks"] < 2 or hash_grew["trees"] != 6:
        raise AssertionError(f"devd streams: {stream_grew}, {hash_grew}")
    want_kernels = ["dsm", "ripemd160", "merkle_tree", "b1"] + (["comb", "tables"] if claim["kernel"] == "comb" else [])
    idle = [k for k in want_kernels if launches[k] <= 0]
    if idle or launches["b2"] or launches["sha256"] or (claim["kernel"] == "f32p" and launches["comb"]):
        raise AssertionError(f"devd kernel launches {launches}: {idle} never launched")

    # -- phase 22: times -------------------------------------------------------
    phase_start(22, "device daemon times")
    paths["hash_stream_parts"] = [lambda: jobs["parts"](client), lambda: ops_merkle.part_set_nodes(parts, DEVICE)]
    warm = {label: min(timed(through) for _ in range(3)) for label, (through, _) in paths.items()}
    warm_local = {label: min(timed(here) for _ in range(3)) for label, (_, here) in paths.items()}
    bench = client.bench(batch=8192, n_batches=8)
    log({"phase": "devd_time", **tag, "kernel": claim["kernel"], "claim_s": claim.get("claim_s"),
         "build_s": claim.get("build_s"),
         "bake_off_sigs_per_s": claim["bake_off_sigs_per_s"], "chunk": claim.get("chunk"),
         "chunk_sigs_per_s": claim["chunk_sigs_per_s"], "bench_sigs_per_s": bench["sigs_per_sec"],
         "bench": {k: bench[k] for k in ("batch", "n_batches", "elapsed_s", "all_ok", "kernel")},
         "first_devd_s": first, "first_in_process_s": first_local,
         "warm_best_of_3_devd_s": warm, "warm_best_of_3_in_process_s": warm_local,
         "hash_stream_mb_per_s": n_bytes / warm["hash_stream_parts"] / 1e6, "parts_bytes": n_bytes})
    if not bench["all_ok"]:
        raise AssertionError(f"devd bench: {bench}")
    client.close()
    return {"launches": launches, "warm": warm, "chunk": claim.get("chunk")}


# -- phases 23 and 24: the multi-daemon plane ----------------------------------


def fleet_phase(name, power, commits, forged, sub_quorum, shapes, block_txs, params, one) -> dict:
    """Phases 23 and 24: FLEET daemons on cuda:0 behind TENDERMINT_DEVD_SOCKS.
    `one` is phase 22's: the one daemon's warm times and chunk width.
    Returns the fleet's launches a kernel over phase 23's paths (summed over
    the daemons)."""
    import shutil

    import torch

    tag = {"card": name, "power_limit": power}
    knobs = {"TENDERMINT_DEVD_KERNEL": "f32p", "TENDERMINT_DEVD_WARM": FLEET_WARM}
    if one.get("chunk"):
        knobs["TENDERMINT_DEVD_CHUNK"] = str(one["chunk"])
    fleet = []
    try:
        for _ in range(FLEET):
            fleet.append(DaemonOnCard(knobs))
        held = [d.wait_held() for d in fleet]
        claims = [claim_log(d.log_text()) for d in fleet]
        free, total = torch.cuda.mem_get_info()
        log({"phase": "devd_fleet_claim", **tag, "daemons": FLEET, "held_after_s": held, "claims": claims,
             "mem_free_bytes": free, "mem_total_bytes": total})
        if any(c.get("kernel") != "f32p" for c in claims):
            raise AssertionError(f"fleet daemons serve {[c.get('kernel') for c in claims]}, not f32p")
        with routed_to(*[d.sock for d in fleet]):
            launches, ctx = _fleet_paths(fleet, tag, commits, forged, sub_quorum, shapes, block_txs, params)
        _fleet_chaos(fleet, tag, ctx)
        phase_start(24, "multi-daemon times")
        _fleet_times(fleet, tag, ctx, one)
        return launches
    finally:
        for d in fleet:
            d.stop()
            log({"phase": "devd_fleet_stopped", "exit": d.proc.returncode})
            shutil.rmtree(d.dir, ignore_errors=True)


def _fleet_paths(fleet, tag, commits, forged, sub_quorum, shapes, block_txs, params):
    """Phase 23's paths through the fleet, each against the in-process
    kernels; the daemons' counts read before and after. Returns their
    launches a kernel and what the chaos and the times reuse."""
    from tendermint_tpu_torch import devd
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import devd_backend, devd_shard, gateway
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import merkle as ops_merkle
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    if not devd_shard.enabled() or gateway.kernel_name() != "devd":
        raise AssertionError(f"TENDERMINT_DEVD_SOCKS={os.environ.get('TENDERMINT_DEVD_SOCKS')!r}: "
                             f"shard {devd_shard.enabled()}, kernel {gateway.kernel_name()!r}")
    clients = [devd.DevdClient(d.sock) for d in fleet]
    v = gateway.Verifier()
    local = gateway.Verifier(device=DEVICE)
    if v.kernel != "devd" or v.device is not None:
        raise AssertionError(f"default Verifier under the fleet: kernel {v.kernel}, device {v.device}")
    vs100, bid100, c100 = commits["commit_small"]
    vs1000, group = commits["fast_sync_group"]
    vs10k, bid10k, c10k = commits["commit_large"]
    part_size = params.block_gossip.block_part_size_bytes
    aggs, terms = {}, {}
    for label in ("agg_100", "agg_400"):
        vs, _, c = commits[label]
        agg = aggs[label] = AggregateCommit.from_commit(c, CHAIN_ID, vs)
        idxs = agg.signers.indices()
        terms[label] = ed25519_agg.aggregate_terms([vs.get_by_index(i)[1].pub_key.raw for i in idxs],
                                                   [agg.sign_message(CHAIN_ID)] * len(idxs), agg.rs, agg.s_agg)
    big = shapes["commit_large"]
    hashers = {}

    def block_path(label, h, route):
        hashers[label, route] = h
        out = make_block_with(h, block_txs[label], commits["commit_small"], part_size)
        ptx.set_batch_tx_root(None)
        return out

    paths = {
        "commit_small": [lambda ver=ver: vs100.verify_commit(
            CHAIN_ID, bid100, 1, c100, batch_verifier=ver.commit_batch_verifier()) for ver in (v, local)],
        "fast_sync_group": [lambda ver=ver: [f() for f in vs1000.verify_commits_async(
            CHAIN_ID, [(bid, h, c) for bid, c, h in group], ver.verify_batch_async)] for ver in (v, local)],
        "commit_large": [lambda ver=ver: vs10k.verify_commit(
            CHAIN_ID, bid10k, 1, c10k, batch_verifier=ver.commit_batch_verifier()) for ver in (v, local)],
        "verify_batch_10k": [lambda: [bool(b) for b in v.verify_batch_async(big)()],
                             lambda: [bool(b) for b in f32p.verify_batch(big, DEVICE)]],
        **{label: [lambda label=label, ver=ver: aggs[label].verify(
            CHAIN_ID, commits[label][0], agg_verifier=ver.verify_aggregate) for ver in (v, local)]
           for label in aggs},
        **{f"make_block_{label}": [lambda label=label: block_path(label, gateway.Hasher(), "fleet"),
                                   lambda label=label: block_path(label, gateway.Hasher(device=DEVICE), "local")]
           for label in block_txs},
    }

    stats0 = [c.stats() for c in clients]
    launches0 = [d.launches(c) for d, c in zip(fleet, clients)]
    out = {}
    for label, (through, here) in paths.items():
        out[label] = through()
        out[label, "local"] = here()
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    lane_sets = {**{k: shapes[k] for k in ("commit_small", "fast_sync_group", "commit_large")},
                 "forged": recorded_items(vs100, 1, bid100, forged)}
    differ, alone = {}, {}
    for label, items in lane_sets.items():
        got = v.verify_batch(items)
        want = [bool(b) for b in f32p.verify_batch(items, DEVICE)]
        differ[label] = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        alone[label] = want
        if want.count(False) != (1 if label == "forged" else 0):
            raise AssertionError(f"{label}: B1 refused {want.count(False)} lanes")
    differ["verify_batch_10k"] = (sum(a != b for a, b in zip(out["verify_batch_10k"], alone["commit_large"]))
                                  + abs(len(out["verify_batch_10k"]) - len(big)))
    for label in aggs:
        if out[label] != out[label, "local"]:
            raise AssertionError(f"{label}: {out[label]!r} through the fleet, {out[label, 'local']!r} here")
        points = devd_backend.agg_batch(terms[label])
        want = ed32.dsm_batch(terms[label], DEVICE)
        differ[f"{label}_points"] = sum(a != b for a, b in zip(points, want)) + abs(len(points) - len(want))
    hashed = {}
    for label in block_txs:
        block, ps = out[f"make_block_{label}"]
        h = hashers[label, "fleet"]
        if h._route != "devd":
            raise AssertionError(f"default Hasher route {h._route!r} under the fleet")
        ref, ref_ps = block_path(label, host_hasher(), "host")
        same = (block.to_bytes() == ref.to_bytes() and ps.header() == ref_ps.header()
                and all(ps.get_part(i).proof == ref_ps.get_part(i).proof for i in range(ps.total)))
        stats = h.stats()
        hashed[label] = {"parts": ps.total, "host_floor_equal": same,
                         **{k: stats[k] for k in ("tpu_part_batches", "tpu_tx_roots", "cpu_leaves",
                                                  "breaker_state")}}
        if hashed[label] != {"parts": ps.total, "host_floor_equal": True, "tpu_part_batches": 1,
                             "tpu_tx_roots": 1, "cpu_leaves": 0, "breaker_state": 0}:
            raise AssertionError(f"{label} through the fleet: {hashed[label]}")
    cap_block, cap_ps = out["make_block_block_cap"]
    data = cap_block.to_bytes()
    parts = [data[i:i + part_size] for i in range(0, len(data), part_size)]
    digests, nodes = devd_backend.hash_tree(parts, "part")
    want_digests, want_nodes = ops_merkle.part_set_nodes(parts, DEVICE)
    differ["block_cap_parts"] = (sum(a != b for a, b in zip(digests, want_digests))
                                 + sum(a != b for a, b in zip(nodes, want_nodes[len(parts):]))
                                 + abs(len(digests) - len(parts)) + abs(len(nodes) - (len(parts) - 1)))

    launches1 = [d.launches(c) for d, c in zip(fleet, clients)]
    stats1 = [c.stats() for c in clients]
    per_daemon = [{k: b[k] - a[k] for k in b} for a, b in zip(launches0, launches1)]
    launches = {k: sum(d[k] for d in per_daemon) for k in per_daemon[0]}
    grew = [{k: b[k] - a[k] for k in ("tpu_sigs", "cpu_sigs")} for a, b in zip(stats0, stats1)]
    mine = v.stats()
    endpoints = devd_shard.endpoint_stats()
    breakers = gateway.devd_breaker_states()
    log({"phase": "devd_fleet_path", **tag, "launches": per_daemon, "daemon_grew": grew,
         "lanes_sent": mine["tpu_sigs"], "verifier_stats": mine, "endpoints": endpoints,
         "plane": devd_shard.plane_stats(), "differ": differ, "hashed": hashed, "breakers": breakers,
         "refused": refusals})
    if any(differ.values()):
        raise AssertionError(f"fleet results differ from the in-process kernels: {differ}")
    if sum(g["tpu_sigs"] for g in grew) != mine["tpu_sigs"] or any(g["cpu_sigs"] for g in grew) \
            or mine["cpu_sigs"] or mine["agg_lanes_cpu"]:
        raise AssertionError(f"fleet lanes: sent {mine['tpu_sigs']}, daemons grew {grew}, verifier {mine}")
    if any(e["sigs"] <= 0 or e["hash_bytes"] <= 0 for e in endpoints.values()):
        raise AssertionError(f"an endpoint served nothing: {endpoints}")
    if set(breakers.values()) != {gateway.CircuitBreaker.CLOSED} or len(breakers) < FLEET:
        raise AssertionError(f"fleet breakers {breakers}")
    for i, got in enumerate(per_daemon):
        idle = [k for k in ("b1", "dsm", "ripemd160") if got[k] <= 0]
        if idle or any(got[k] for k in ("b2", "sha256", "comb", "tables", "merkle_tree")):
            raise AssertionError(f"fleet daemon {i} launches {got}: {idle} never launched")
    for c in clients:
        c.close()
    ctx = {"paths": paths, "big": big, "want_big": alone["commit_large"], "parts": parts, "cap_bytes": data,
           "cap_header": cap_ps.header(), "cap_proofs": [cap_ps.get_part(i).proof for i in range(cap_ps.total)],
           "block_path": block_path, "commits": commits, "block_txs": block_txs}
    return launches, ctx


def _fleet_chaos(fleet, tag, ctx) -> None:
    """Phase 23's chaos: endpoint 1 behind a FaultProxy, blacked out while
    the 10,000-lane batch and the block_cap build run, until its breaker
    opens; endpoint 0 absorbs every slice, nothing takes the CPU, and after
    the blackout traffic re-closes endpoint 1's breaker and it serves
    again. Then the supervisor's refusal of a card daemon."""
    import threading

    from tendermint_tpu_torch.ops import devd_shard, faults, gateway

    proxy_sock = os.path.join(fleet[1].dir, "proxy.sock")
    proxy = faults.FaultProxy(proxy_sock, fleet[1].sock).start()
    rounds, errors = [], []
    try:
        with routed_to(fleet[0].sock, proxy_sock):
            v = gateway.Verifier()
            big, want_big = ctx["big"], ctx["want_big"]
            cpu_leaves = []

            def chaos_round() -> None:
                got = [bool(b) for b in v.verify_batch_async(big)()]
                h = gateway.Hasher()
                block, ps = ctx["block_path"]("block_cap", h, "chaos")
                cpu_leaves.append(h.stats()["cpu_leaves"])
                same = (got == want_big and block.to_bytes() == ctx["cap_bytes"]
                        and ps.header() == ctx["cap_header"]
                        and [ps.get_part(i).proof for i in range(ps.total)] == ctx["cap_proofs"])
                rounds.append(same)

            def first_round() -> None:
                try:
                    chaos_round()
                except Exception as exc:  # noqa: BLE001 - raised below
                    errors.append(repr(exc))

            br1 = gateway.devd_breaker(proxy_sock)
            br0 = gateway.devd_breaker(fleet[0].sock)
            chaos_round()  # both endpoints serving, through the proxy
            t0 = time.perf_counter()
            during = threading.Thread(target=first_round)
            during.start()
            time.sleep(0.01)
            proxy.blackout(FLEET_BLACKOUT_S)
            dark_from = time.perf_counter()
            during.join(timeout=FLEET_WAIT_S)
            if errors or during.is_alive():
                raise AssertionError(f"chaos round under the blackout: {errors}")
            while br1.state != br1.OPEN:
                if time.perf_counter() - t0 > FLEET_WAIT_S:
                    raise AssertionError(f"endpoint 1's breaker never opened: {br1.stats()}")
                if time.perf_counter() - dark_from > FLEET_BLACKOUT_S / 2:
                    # endpoint 1 stays dark until its breaker opens
                    proxy.blackout(FLEET_BLACKOUT_S)
                    dark_from = time.perf_counter()
                chaos_round()
            opened_s = time.perf_counter() - t0
            states_open = {"endpoint_0": br0.state, "endpoint_1": br1.state}
            time.sleep(max(0.0, FLEET_BLACKOUT_S - (time.perf_counter() - dark_from)))
            while br1.state != br1.CLOSED:
                if time.perf_counter() - t0 > 2 * FLEET_WAIT_S:
                    raise AssertionError(f"endpoint 1's breaker never re-closed: {br1.stats()}")
                chaos_round()
                time.sleep(0.05)
            closed_s = time.perf_counter() - t0
            served_before = devd_shard.endpoint_stats()[proxy_sock]["sigs"]
            chaos_round()
            endpoints = devd_shard.endpoint_stats()
            mine = v.stats()
            fault_counts = {k: val for k, val in mine.items() if k.startswith("faults_")}
            log({"phase": "devd_fleet_chaos", **tag, "blackout_s": FLEET_BLACKOUT_S, "rounds": len(rounds),
                 "rounds_equal": sum(rounds), "opened_after_s": opened_s, "closed_after_s": closed_s,
                 "states_while_open": states_open, "breaker_1": br1.stats(), "breaker_0": br0.stats(),
                 "endpoints": endpoints, "cpu_sigs": mine["cpu_sigs"], "cpu_leaves": sum(cpu_leaves),
                 "faults": fault_counts, "proxy": proxy.plan.stats()})
            if not all(rounds):
                raise AssertionError(f"{rounds.count(False)} of {len(rounds)} chaos rounds differ")
            if states_open != {"endpoint_0": 0, "endpoint_1": 2} or br0.stats()["breaker_opens"]:
                raise AssertionError(f"breakers under the blackout: {states_open}, {br0.stats()}")
            if mine["cpu_sigs"] or sum(cpu_leaves):
                raise AssertionError(f"chaos took the CPU: {mine['cpu_sigs']} sigs, {sum(cpu_leaves)} leaves")
            if fault_counts.get("faults_kill", 0) < 1 or endpoints[proxy_sock]["redispatches"] < 1:
                raise AssertionError(f"faults {fault_counts}, endpoints {endpoints}")
            if endpoints[proxy_sock]["sigs"] <= served_before:
                raise AssertionError(f"endpoint 1 serves no lanes after re-closing: {endpoints}")
    finally:
        proxy.stop()
    refusal = None
    for accept in ("", "0"):
        try:
            faults.DaemonSupervisor(os.path.join(fleet[0].dir, "card.sock"),
                                    {"TENDERMINT_DEVD_ACCEPT_CPU": accept})
        except ValueError as exc:
            if "ACCEPT_CPU" not in str(exc):
                raise
            refusal = str(exc)[:60]
        else:
            raise AssertionError(f"DaemonSupervisor took a card daemon (ACCEPT_CPU={accept!r})")
    log({"phase": "devd_fleet_supervisor", "refused": refusal})


def _fleet_times(fleet, tag, ctx, one) -> None:
    """Phase 24: each path's slice plan through the fleet; warm best of 3
    through the fleet, through one of its daemons alone and in process, in
    turns (a warm-up turn first), beside phase 22's one daemon; and the
    split of the wide paths' time through a daemon."""
    from tendermint_tpu_torch import devd
    from tendermint_tpu_torch.ops import devd_backend, devd_shard
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import merkle as ops_merkle

    paths, parts, big = ctx["paths"], ctx["parts"], ctx["big"]
    vs10k, bid10k, c10k = ctx["commits"]["commit_large"]
    timed_paths = {
        **{label: paths[label] for label in ("commit_large", "fast_sync_group", "verify_batch_10k",
                                             "make_block_block_cap")},
        "parts_tree": [lambda: devd_backend.hash_tree(parts, "part"),
                       lambda: ops_merkle.part_set_nodes(parts, DEVICE)],
    }
    # phase 22's name of the same call through one daemon
    one_name = {"verify_batch_10k": "verify_stream_10k", "parts_tree": "hash_stream_parts"}
    routes = {"fleet": [d.sock for d in fleet], "one_daemon": [fleet[0].sock]}
    plans = {}
    with routed_to(*routes["fleet"]):
        for label, (through, _) in timed_paths.items():
            before = devd_shard.endpoint_stats()
            through()
            after = devd_shard.endpoint_stats()
            plans[label] = [{k: after[p][k] - before[p][k] for k in
                             ("dispatched_slices", "stolen_slices", "redispatches", "sigs", "hash_bytes")}
                            for p in after]
    best: dict[str, dict[str, float]] = {route: {} for route in (*routes, "in_process")}
    for turn in range(4):
        for route, socks in routes.items():
            with routed_to(*socks):
                for label, (through, _) in timed_paths.items():
                    t = timed(through)
                    if turn:
                        best[route][label] = min(best[route].get(label, t), t)
        for label, (_, here) in timed_paths.items():
            t = timed(here)
            if turn:
                best["in_process"][label] = min(best["in_process"].get(label, t), t)
    warm, warm_one, warm_local = best["fleet"], best["one_daemon"], best["in_process"]
    log({"phase": "devd_fleet_time", **tag, "daemons": FLEET, "warm_best_of_3_fleet_s": warm,
         "warm_best_of_3_one_daemon_s": warm_one, "warm_best_of_3_in_process_s": warm_local,
         "phase22_one_daemon_s": {label: one["warm"].get(one_name.get(label, label)) for label in timed_paths},
         "slice_plan": plans})

    # where a wide path's time through a daemon goes: each piece alone on
    # the same payload, best of 3
    client = devd.DevdClient(fleet[0].sock)
    width = client.stream_chunk()
    client.close()

    def chunks(items, w):
        return [items[i:i + w] for i in range(0, len(items), w)]

    def best(fn) -> float:
        return min(timed(fn) for _ in range(3))

    txs = ctx["block_txs"]["block_cap"]
    verify_frames = [devd._pack_chunk(c) for c in chunks(big, width)]
    tx_frames = [devd._pack_hash_chunk(c) for c in chunks(txs, width)]
    part_frames = [devd._pack_hash_chunk(c) for c in chunks(parts, devd_backend._hash_chunk("part"))]
    pieces = {
        "commit_large": {
            "encode_s": best(lambda: [devd._pack_chunk(c) for c in chunks(big, width)]),
            "decode_s": best(lambda: [devd._unpack_chunk(f) for f in verify_frames]),
            "commit_check_s": best(lambda: recorded_items(vs10k, 1, bid10k, c10k)),
            "marshal_and_kernel_s": best(lambda: f32p.verify_batch(big, DEVICE)),
        },
        "make_block_block_cap": {
            "encode_s": best(lambda: ([devd._pack_hash_chunk(c) for c in chunks(txs, width)],
                                      [devd._pack_hash_chunk(c) for c in chunks(parts, 8)])),
            "decode_s": best(lambda: [devd._unpack_hash_chunk(f) for f in tx_frames + part_frames]),
            "in_process_build_s": warm_local["make_block_block_cap"],
        },
        "parts_stream": {
            "encode_s": best(lambda: [devd._pack_hash_chunk(c) for c in chunks(parts, 8)]),
            "decode_s": best(lambda: [devd._unpack_hash_chunk(f) for f in part_frames]),
            "marshal_and_kernel_s": warm_local["parts_tree"],
        },
    }
    for label, key in (("commit_large", "commit_large"), ("make_block_block_cap", "make_block_block_cap"),
                       ("parts_stream", "parts_tree")):
        known = sum(pieces[label].values())
        pieces[label].update(one_daemon_s=warm_one[key], fleet_s=warm[key],
                             left_one_daemon_s=warm_one[key] - known, left_fleet_s=warm[key] - known)
    log({"phase": "devd_wide_split", **tag, "chunk": width, "frames": {
        "verify": len(verify_frames), "tx": len(tx_frames), "parts": len(part_frames)}, "pieces": pieces})


# -- phases 25 and 26: the ABCI application plane ------------------------------


def make_app_inputs(pool, rng) -> dict:
    """Phase 25's inputs, from their own generator so the earlier phases'
    draws stay as they were: the state (APP_STATE_KEYS keys `acct-%07d`,
    APP_VALUE_BYTES random bytes each), APP_HEIGHTS blocks of APP_BLOCK and
    one socket block of APP_SOCKET_BLOCK, each a shuffle of updates of live
    keys, new keys, `rm:` deletions and updates whose signature has a
    flipped bit, signed by APP_SIGNERS keys in the pool; and the keys whose
    proofs phase 25 checks, APP_PROOF_KEYS of each kind."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    n, width = APP_STATE_KEYS, APP_VALUE_BYTES
    values = rng.bytes(n * width)
    entries = {b"acct-%07d" % i: values[i * width:(i + 1) * width] for i in range(n)}
    seeds = [rng.bytes(32) for _ in range(APP_SIGNERS)]
    pubs = pool.map(ed.public_key, seeds)
    live = sorted(entries)
    next_key = n
    plans = []
    for shape in [APP_BLOCK] * APP_HEIGHTS + [APP_SOCKET_BLOCK]:
        counts = dict(shape)
        kinds = [k for k, c in shape for _ in range(c)]
        kinds = [kinds[i] for i in rng.permutation(len(kinds))]
        picks = iter(rng.choice(len(live), size=len(kinds) - counts["new"], replace=False).tolist())
        plan = {"payloads": [], "forged": [], "updated": [], "deleted": [], "new": []}
        for pos, kind in enumerate(kinds):
            if kind == "new":
                key = b"acct-%07d" % next_key
                next_key += 1
                plan["new"].append(key)
                plan["payloads"].append(key + b"=" + rng.bytes(width))
                continue
            key = live[next(picks)]
            if kind == "delete":
                plan["deleted"].append(key)
                plan["payloads"].append(b"rm:" + key)
                continue
            plan["payloads"].append(key + b"=" + rng.bytes(width))
            if kind == "forged":
                plan["forged"].append(pos)
            else:
                plan["updated"].append(key)
        plan["signers"] = rng.integers(0, APP_SIGNERS, size=len(kinds)).tolist()
        gone = set(plan["deleted"])
        live = [k for k in live if k not in gone] + plan["new"]
        plans.append(plan)
    jobs = [(seeds[s], p) for plan in plans for s, p in zip(plan["signers"], plan["payloads"])]
    sigs = iter(pool.starmap(ed.sign, jobs, chunksize=256))
    blocks = []
    for plan in plans:
        forged = set(plan["forged"])
        txs = []
        for pos, (s, payload) in enumerate(zip(plan["signers"], plan["payloads"])):
            sig = next(sigs)
            if pos in forged:
                sig = sig[:5] + bytes([sig[5] ^ 0x20]) + sig[6:]
            txs.append(pubs[s] + sig + payload)
        blocks.append({"txs": txs, "forged": sorted(forged)})
    touched = {k for plan in plans[:APP_HEIGHTS] for kind in ("updated", "deleted") for k in plan[kind]}
    pick = lambda keys: [keys[i] for i in rng.choice(len(keys), size=APP_PROOF_KEYS, replace=False)]  # noqa: E731
    deleted = [k for plan in plans[:APP_HEIGHTS] for k in plan["deleted"]]
    proof_keys = {
        "untouched": pick([k for k in sorted(entries) if k not in touched]),
        "updated": pick([k for plan in plans[:APP_HEIGHTS] for k in plan["updated"] if k not in deleted]),
        "deleted": pick(deleted),
        "absent": [b"acct-%07d" % (next_key + 1 + i) for i in range(APP_PROOF_KEYS // 2)]
        + [b"zz-%d" % i for i in range(APP_PROOF_KEYS - APP_PROOF_KEYS // 2)],
    }
    return {"entries": entries, "blocks": blocks, "proof_keys": proof_keys}


class wave_recorder:
    """The state tree's hasher seam, with every batch it is handed recorded:
    its width, the seconds the Hasher took, and the widest batch's
    preimages (each batch is one K1 launch on the card)."""

    def __init__(self, hasher):
        self.hasher = hasher
        self.widths: list[int] = []
        self.seconds = 0.0
        self.widest: list[bytes] = []

    def part_leaf_hashes(self, chunks):
        t0 = time.perf_counter()
        out = self.hasher.part_leaf_hashes(chunks)
        self.seconds += time.perf_counter() - t0
        self.widths.append(len(chunks))
        if len(chunks) > len(self.widest):
            self.widest = list(chunks)
        return out

    def take(self) -> tuple[list[int], float]:
        out = (self.widths, self.seconds)
        self.widths, self.seconds = [], 0.0
        return out


class stage_clock:
    """Inside the block, the seconds spent in each named method, patched on
    its class (every instance's calls) or on one instance; put back after."""

    _MISSING = object()

    def __init__(self, **targets):
        self.targets = targets
        self.seconds = dict.fromkeys(targets, 0.0)

    def __enter__(self):
        self.saved = []
        for label, (owner, attr) in self.targets.items():
            orig = getattr(owner, attr)

            def timed_call(*args, _orig=orig, _label=label, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _orig(*args, **kwargs)
                finally:
                    self.seconds[_label] += time.perf_counter() - t0

            self.saved.append((owner, attr, vars(owner).get(attr, self._MISSING)))
            setattr(owner, attr, timed_call)
        return self

    def __exit__(self, *exc):
        for owner, attr, prev in reversed(self.saved):
            if prev is self._MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, prev)
        return False


def _sync() -> None:
    import torch

    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def _launch_delta(launches: dict[str, int], want: dict[str, int], label: str) -> None:
    expected = dict.fromkeys(launches, 0)
    expected.update(want)
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches}, expected {expected}")


def app_phase(name, power, inputs) -> dict:
    """Phase 25: the ABCI application plane on the card, in process (no
    daemon socket in the environment, the default Verifier and Hasher on
    the local route, asserted). A host-built SignedKVStoreApp's snapshot
    restores into an app whose tree hashes through `default_hasher()` (K1
    on every wave of 32 or more); then APP_HEIGHTS blocks drive through
    `AppConns(LocalClientCreator(app))` as state/execution.py drives them
    (begin_block, one deliver_txs_async of the whole block, end_block,
    commit), each verified in one B1 launch through `default_verifier()`
    and sharded over APP_SHARDS, beside the reference: the same app class
    with the host's hashing and a Verifier whose gate sends every lane to
    the native CPU floor. Launches are reset just before each path and read
    just after. Responses, app hashes and sampled proofs must be equal; a
    socket block through ABCIServer / SocketClient too. Returns what phase
    26 times and the launches a kernel over these paths."""
    import torch

    from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp
    from tendermint_tpu_torch.abci.client import ABCIServer, SocketClient
    from tendermint_tpu_torch.abci.types import Header
    from tendermint_tpu_torch.merkle.statetree_proof import TreeProof
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops.gateway import Verifier
    from tendermint_tpu_torch.proxy import AppConns, LocalClientCreator
    from tendermint_tpu_torch.statetree import VersionedTree

    tag = {"card": name, "power_limit": power}
    dev_type = torch.device(DEVICE).type
    total = {"b1": 0, "ripemd160": 0}
    with routed_to():
        gateway._default_verifier = gateway._default_hasher = None
        verifier = gateway.default_verifier()
        hasher = gateway.default_hasher()
        if verifier.kernel != "f32p" or verifier.device is None or verifier.device.type != dev_type:
            raise AssertionError(f"default Verifier: kernel {verifier.kernel}, device {verifier.device}")
        if hasher._route != "local" or hasher.device is None or hasher.device.type != dev_type:
            raise AssertionError(f"default Hasher: route {hasher._route}, device {hasher.device}")

        # the host-built app and its snapshot
        t0 = time.perf_counter()
        entries = inputs["entries"]
        host = SignedKVStoreApp()
        host.tree = VersionedTree.from_entries(entries, 1)
        host.state = {k.decode("latin-1"): v for k, v in entries.items()}
        host.height, host.app_hash = 1, host.tree.root_hash()
        host.deliver_verifier = Verifier(min_tpu_batch=APP_REF_GATE, device="cpu")
        host.shards = APP_SHARDS
        snap = host.snapshot()
        host_build_s = time.perf_counter() - t0

        # the restore on the card
        rec = wave_recorder(hasher)
        card = SignedKVStoreApp()
        card.tree.hasher = rec
        card.shards = APP_SHARDS
        leaves0 = hasher.stats()["tpu_leaves"]
        reset_launches()
        t0 = time.perf_counter()
        card.restore(snap)
        _sync()
        restore_s = time.perf_counter() - t0
        launches = read_launches()
        widths, k1_s = rec.take()
        gw = card.tree.stats()["gateway_nodes"]
        tpu_leaves = hasher.stats()["tpu_leaves"] - leaves0
        if card.app_hash != host.app_hash or card.height != 1:
            raise AssertionError("restore: the card app's hash differs from the host app's")
        if not (tpu_leaves == gw == sum(widths) >= APP_MIN_GATEWAY * APP_STATE_KEYS):
            raise AssertionError(f"restore: tpu_leaves {tpu_leaves}, gateway_nodes {gw}, waves {widths}")
        if min(widths) < 32:
            raise AssertionError(f"restore: a wave of {min(widths)} went to the Hasher")
        _launch_delta(launches, {"ripemd160": len(widths)}, "restore")
        total["ripemd160"] += launches["ripemd160"]
        log({"phase": "app_restore", **tag, "keys": APP_STATE_KEYS, "snapshot_bytes": len(snap),
             "app_hash": card.app_hash.hex(), "tpu_leaves": tpu_leaves, "gateway_nodes": gw,
             "hashed_nodes": card.tree.stats()["hashed_nodes"], "k1_waves": len(widths),
             "widest_wave": max(widths), "launches": launches, "first_restore_s": restore_s,
             "hasher_s": k1_s, "host_build_s": host_build_s})

        # the blocks through AppConns, card beside the host reference
        apps = {"card": card, "host": host}
        verifiers = {"card": verifier, "host": host.deliver_verifier}
        conns = {label: AppConns(LocalClientCreator(app)) for label, app in apps.items()}
        for c in conns.values():
            c.start()
        hashes = []
        for height, blk in zip(range(2, 2 + APP_HEIGHTS), inputs["blocks"][:APP_HEIGHTS]):
            txs, seen = blk["txs"], {}
            for label, app in apps.items():
                con = conns[label].consensus()
                v0 = verifiers[label].stats()
                header = Header(chain_id=CHAIN_ID, height=height, time_ns=BLOCK_TIME_NS + height,
                                num_txs=len(txs), app_hash=app.app_hash)
                reset_launches()
                con.begin_block_sync(hashlib.sha256(b"app-block-%d" % height).digest()[:20], header)
                t0 = time.perf_counter()
                reses = [rr.response for rr in con.deliver_txs_async(txs)]
                _sync()
                deliver_s = time.perf_counter() - t0
                end = con.end_block_sync(height)
                l_deliver = read_launches()
                deliver_widths, _ = rec.take()
                reset_launches()
                t0 = time.perf_counter()
                commit = con.commit_sync()
                _sync()
                commit_s = time.perf_counter() - t0
                l_commit = read_launches()
                commit_widths, _ = rec.take()
                v1 = verifiers[label].stats()
                sigs = {k: v1[k] - v0[k] for k in ("tpu_batches", "tpu_sigs", "cpu_sigs")}
                if label == "card":
                    if sigs != {"tpu_batches": 1, "tpu_sigs": len(txs), "cpu_sigs": 0}:
                        raise AssertionError(f"block {height}: card verifier {sigs}")
                    if len(deliver_widths) != 1 or not commit_widths:
                        raise AssertionError(f"block {height}: K1 batches {deliver_widths} / {commit_widths}")
                    _launch_delta(l_deliver, {"b1": 1, "ripemd160": 1}, f"block {height} deliver")
                    _launch_delta(l_commit, {"ripemd160": len(commit_widths)}, f"block {height} commit")
                    total["b1"] += l_deliver["b1"]
                    total["ripemd160"] += l_deliver["ripemd160"] + l_commit["ripemd160"]
                else:
                    if sigs != {"tpu_batches": 0, "tpu_sigs": 0, "cpu_sigs": len(txs)}:
                        raise AssertionError(f"block {height}: host verifier {sigs}")
                    _launch_delta(l_deliver, {}, f"block {height} host deliver")
                    _launch_delta(l_commit, {}, f"block {height} host commit")
                seen[label] = {"responses": [(r.code, r.log) for r in reses], "end": end.to_json(),
                               "commit": commit.to_json()}
                log({"phase": "app_block", **tag, "app": label, "height": height, "txs": len(txs),
                     "refused": sum(r.code != 0 for r in reses), "sigs": sigs,
                     "launches_deliver": l_deliver, "launches_commit": l_commit,
                     "priority_batch": deliver_widths, "commit_waves_k1": commit_widths,
                     "commit_nodes": app.tree.stats()["last_commit_nodes"],
                     "deliver_s": deliver_s, "commit_s": commit_s, "app_hash": app.app_hash.hex()})
            if seen["card"] != seen["host"]:
                raise AssertionError(f"block {height}: the card app's responses or hash differ from the host's")
            refused = [i for i, (code, _) in enumerate(seen["card"]["responses"]) if code != 0]
            if refused != blk["forged"]:
                raise AssertionError(f"block {height}: refused {refused}, forged {blk['forged']}")
            hashes.append(card.app_hash)
        if card.sharded_batches != APP_HEIGHTS or host.sharded_batches != APP_HEIGHTS:
            raise AssertionError(f"sharded batches {card.sharded_batches} / {host.sharded_batches}")
        if hasher.stats()["cpu_leaves"] != 0:
            raise AssertionError(f"the Hasher hashed {hasher.stats()['cpu_leaves']} leaves on the host")

        # proofs against the committed root, the card's equal to the host's
        proofs = {}
        for kind, keys in inputs["proof_keys"].items():
            for key in keys:
                got = conns["card"].query().query_sync(key, prove=True)
                want = conns["host"].query().query_sync(key, prove=True)
                if got.to_json() != want.to_json():
                    raise AssertionError(f"proof of {key!r} ({kind}) differs from the host's")
                proof = TreeProof.from_json(json.loads(got.proof))
                member = kind in ("untouched", "updated")
                if proof.is_membership != member or not proof.verify(card.app_hash):
                    raise AssertionError(f"proof of {key!r} ({kind}) does not verify")
                proofs[kind] = proofs.get(kind, 0) + 1
        for c in conns.values():
            c.stop()
        log({"phase": "app_plane", **tag, "keys": APP_STATE_KEYS, "heights": APP_HEIGHTS,
             "block": dict(APP_BLOCK), "shards": APP_SHARDS, "app_hashes": [h.hex() for h in hashes],
             "sharded_batches": card.sharded_batches, "proofs_verified": proofs,
             "verifier": verifier.stats(), "hasher": {k: hasher.stats()[k] for k in
                                                      ("tpu_part_batches", "tpu_leaves", "cpu_leaves")},
             "launches": total, "route": {"verify": verifier.kernel, "hash": hasher._route}})

        # the socket wire, for correctness: tx by tx, so each verifies on the host
        blk = inputs["blocks"][APP_HEIGHTS]
        height = 2 + APP_HEIGHTS
        servers = {label: ABCIServer(app, "127.0.0.1:0") for label, app in apps.items()}
        clients = {}
        seen = {}
        try:
            for label in apps:
                servers[label].start()
                clients[label] = SocketClient(servers[label].addr)
                clients[label].start()
            for label, cli in clients.items():
                reset_launches()
                t0 = time.perf_counter()
                cli.begin_block_sync(hashlib.sha256(b"app-block-%d" % height).digest()[:20],
                                     Header(chain_id=CHAIN_ID, height=height, num_txs=len(blk["txs"])))
                rrs = [cli.deliver_tx_async(tx) for tx in blk["txs"]]
                reses = [rr.wait(120) for rr in rrs]
                if any(r is None for r in reses):
                    raise AssertionError(f"socket block: {label} lost a response")
                cli.end_block_sync(height)
                commit = cli.commit_sync()
                launches = read_launches()
                seen[label] = ([(r.code, r.log) for r in reses], commit.to_json())
                log({"phase": "app_socket", **tag, "app": label, "txs": len(blk["txs"]),
                     "launches": launches, "wall_s": time.perf_counter() - t0,
                     "app_hash": commit.data.hex()})
                if label == "card":
                    if launches["ripemd160"] < 1:
                        raise AssertionError("socket block: the card app's commit launched no K1")
                    _launch_delta(launches, {"ripemd160": launches["ripemd160"]}, "socket block")
                    total["ripemd160"] += launches["ripemd160"]
                else:
                    _launch_delta(launches, {}, "socket block, host")
        finally:
            for cli in clients.values():
                cli.stop()
            for srv in servers.values():
                srv.stop()
        if seen["card"] != seen["host"]:
            raise AssertionError("socket block: the card app's responses or hash differ from the host's")
        refused = [i for i, (code, _) in enumerate(seen["card"][0]) if code != 0]
        if refused != blk["forged"]:
            raise AssertionError(f"socket block: refused {refused}, forged {blk['forged']}")
    return {"snap": snap, "hasher": hasher, "verifier": verifier, "rec": rec, "hashes": hashes,
            "blocks": inputs["blocks"][:APP_HEIGHTS], "launches": total}


def app_time(name, power, ctx) -> None:
    """Phase 26: the card against the host reference: the restore, best of
    APP_RESTORE_RUNS (its hashing, and the Hasher's K1 calls within it), and the
    three blocks of phase 25 replayed on freshly restored apps, each split
    into the verify (B1 and its marshal, or the native CPU floor), the
    priorities, the fold and the commit (its hashing, the K1 calls, the
    waves and their widths); then K1's device time on the widest wave of a
    restore and of a commit beside the host's hashlib on the same
    preimages. Card and host run in turns, each timed call after a full
    collection of the heap."""
    from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp
    from tendermint_tpu_torch.abci.types import Header
    from tendermint_tpu_torch.crypto.hashing import ripemd160
    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops import merkle as ops_merkle
    from tendermint_tpu_torch.ops.gateway import Verifier
    from tendermint_tpu_torch.statetree.tree import VersionedTree

    tag = {"card": name, "power_limit": power}
    snap, hasher, verifier, rec = ctx["snap"], ctx["hasher"], ctx["verifier"], ctx["rec"]
    best3 = lambda fn: min(timed(fn) for _ in range(3))  # noqa: E731

    def fresh(label):
        app = SignedKVStoreApp()
        app.shards = APP_SHARDS
        if label == "card":
            app.tree.hasher = rec
            app.deliver_verifier = verifier
        else:
            app.deliver_verifier = Verifier(min_tpu_batch=APP_REF_GATE, device="cpu")
        return app

    # card and host in turns, each timed call after a full collection: the
    # cyclic collector's passes over a heap of millions of tree nodes
    # otherwise land on whichever call crosses its threshold
    restored, runs = {}, {"card": [], "host": []}
    rec.widest = []  # the card restores' widest wave, timed alone below
    with routed_to():
        for _ in range(APP_RESTORE_RUNS):
            for label in ("card", "host"):
                restored.pop(label, None)
                app = fresh(label)
                rec.take()
                gc.collect()
                with stage_clock(hash=(VersionedTree, "_hash_dirty"), build=(VersionedTree, "load_entries")) as clk:
                    t0 = time.perf_counter()
                    app.restore(snap)
                    _sync()
                    wall = time.perf_counter() - t0
                widths, k1_s = rec.take()
                runs[label].append({"restore_s": wall, "tree_build_s": clk.seconds["build"],
                                    "hash_s": clk.seconds["hash"], "hasher_s": k1_s,
                                    "parse_s": wall - clk.seconds["build"] - clk.seconds["hash"],
                                    "k1_waves": len(widths)})
                restored[label] = app
        restore_widest = rec.widest
        restore = {label: min(rows, key=lambda r: r["restore_s"]) for label, rows in runs.items()}
        log({"phase": "app_plane_time", **tag, "what": "restore", "keys": APP_STATE_KEYS,
             "card_best": restore["card"], "host_best": restore["host"],
             "speedup": restore["host"]["restore_s"] / restore["card"]["restore_s"]})

        commit_widest: list[bytes] = []
        blocks = {"card": [], "host": []}
        for i, blk in enumerate(ctx["blocks"]):
            height = 2 + i
            for label, app in restored.items():
                v = app.deliver_verifier
                app.begin_block(b"", Header(chain_id=CHAIN_ID, height=height))
                st0 = app.tree.stats()
                rec.take()
                gc.collect()
                with stage_clock(verify=(v, "verify_batch"), priorities=(app, "_batch_priorities"),
                                 hash=(VersionedTree, "_hash_dirty")) as clk:
                    t0 = time.perf_counter()
                    app.deliver_txs(blk["txs"])
                    _sync()
                    deliver_s = time.perf_counter() - t0
                    _, prio_k1_s = rec.take()
                    rec.widest = []
                    t0 = time.perf_counter()
                    app.commit()
                    _sync()
                    commit_s = time.perf_counter() - t0
                widths, k1_s = rec.take()
                if len(rec.widest) > len(commit_widest):
                    commit_widest = rec.widest
                st1 = app.tree.stats()
                if app.app_hash != ctx["hashes"][i]:
                    raise AssertionError(f"replayed block {height}: {label}'s app hash differs from phase 25's")
                blocks[label].append({
                    "block_s": deliver_s + commit_s, "deliver_s": deliver_s,
                    "verify_s": clk.seconds["verify"], "priorities_s": clk.seconds["priorities"],
                    "priorities_hasher_s": prio_k1_s,
                    "fold_s": deliver_s - clk.seconds["verify"] - clk.seconds["priorities"],
                    "commit_s": commit_s, "commit_hash_s": clk.seconds["hash"], "commit_hasher_s": k1_s,
                    "commit_nodes": st1["last_commit_nodes"],
                    "waves": st1["hash_waves"] - st0["hash_waves"], "k1_waves": widths,
                })
        best = {label: min(rows, key=lambda r: r["block_s"]) for label, rows in blocks.items()}
        log({"phase": "app_plane_time", **tag, "what": "block", "txs": len(ctx["blocks"][0]["txs"]),
             "card_best": best["card"], "host_best": best["host"], "card_blocks": blocks["card"],
             "host_blocks": blocks["host"], "speedup": best["host"]["block_s"] / best["card"]["block_s"],
             "verify_speedup": best["host"]["verify_s"] / best["card"]["verify_s"]})

        # K1 alone on the widest wave of a commit and of a restore
        for label, pre in (("restore", restore_widest), ("commit", commit_widest)):
            words, first, nblocks = th.pack_ragged(pre, True)
            args = th.to_device(words, first, nblocks, DEVICE)
            try:
                dev_ms = device_ms(lambda: th.ripemd160_lanes(*args), "hash_blocks_kernel")
            except RuntimeError:  # no device event in any trace: the CUDA events' time stands
                dev_ms = None
            log({"phase": "app_plane_time", **tag, "what": "k1_widest_wave", "wave": label,
                 "preimages": len(pre), "compressions": len(words), "device_ms": dev_ms,
                 "kernel_ms": cuda_ms(lambda: th.ripemd160_lanes(*args)),
                 "hasher_call_ms": 1e3 * best3(lambda: ops_merkle.part_leaf_hashes(pre, DEVICE)),
                 "hashlib_ms": 1e3 * best3(lambda: [ripemd160(p) for p in pre])})
        del restored


# -- phases 27-28: the execution path ------------------------------------------------


def make_exec_inputs(pool, rng) -> list[dict]:
    """Phase 27's bursts, from their own generator so the earlier phases'
    draws stay as they were: EXEC_HEIGHTS of them, the first of
    EXEC_FIRST_BLOCK and the rest of EXEC_BLOCK (see make_bursts)."""
    return make_bursts(pool, rng, EXEC_HEIGHTS, EXEC_FIRST_BLOCK, EXEC_BLOCK, EXEC_VALUE_BYTES,
                       EXEC_SIGNERS, b"exec-%07d")


def make_bursts(pool, rng, heights, first_shape, shape, value_bytes, signers, key_fmt) -> list[dict]:
    """`heights` bursts of signed kv txs, the first of `first_shape` and the
    rest of `shape`, each a shuffle of new keys (`key_fmt`), updates of the
    earlier heights' keys and txs whose signature has a flipped bit,
    `value_bytes` random bytes a value, signed by `signers` keys in the
    pool."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    seeds = [rng.bytes(32) for _ in range(signers)]
    pubs = pool.map(ed.public_key, seeds)
    live: list[bytes] = []
    next_key = 0
    plans = []
    for height in range(1, heights + 1):
        kinds = [k for k, c in (first_shape if height == 1 else shape) for _ in range(c)]
        kinds = [kinds[i] for i in rng.permutation(len(kinds))]
        old = sum(k != "new" for k in kinds)
        picks = iter(rng.choice(len(live), size=old, replace=False).tolist()) if live else None
        payloads, forged, new = [], [], []
        for pos, kind in enumerate(kinds):
            if kind == "new" or picks is None:
                key = key_fmt % next_key
                next_key += 1
                if kind == "new":
                    new.append(key)
            else:
                key = live[next(picks)]
            payloads.append(key + b"=" + rng.bytes(value_bytes))
            if kind == "forged":
                forged.append(pos)
        live += new
        plans.append((payloads, forged, rng.integers(0, signers, size=len(kinds)).tolist()))
    jobs = [(seeds[s], pl) for payloads, _, signers_of in plans for s, pl in zip(signers_of, payloads)]
    sigs = iter(pool.starmap(ed.sign, jobs, chunksize=256))
    bursts = []
    for payloads, forged, signers_of in plans:
        bad = set(forged)
        txs = []
        for pos, (s, payload) in enumerate(zip(signers_of, payloads)):
            sig = next(sigs)
            if pos in bad:
                sig = sig[:5] + bytes([sig[5] ^ 0x20]) + sig[6:]
            txs.append(pubs[s] + sig + payload)
        bursts.append({"txs": txs, "forged": forged})
    return bursts


def exec_genesis(vs, upgrade_height: int = EXEC_UPGRADE_HEIGHT):
    """The exec_chain (and fast_sync) genesis: the validator set at its
    power, CHAIN_ID, the default ConsensusParams, and the upgrade to
    aggregate commits at `upgrade_height`."""
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    return GenesisDoc(
        genesis_time_ns=BLOCK_TIME_NS, chain_id=CHAIN_ID,
        validators=[GenesisValidator(v.pub_key, v.voting_power) for v in vs.validators],
        upgrade_height=upgrade_height, upgrade_format="aggregate",
    )


def sign_commit(vs, seed_of, height: int, bid, pool=None):
    """The height's precommits for `bid`, every validator of `vs` signing
    (in `pool` when given): the seen commit a node saves with its block, and
    the next block's LastCommit."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto.keys import SignatureEd25519
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote

    votes = [Vote(v.address, idx, height, 0, VOTE_TYPE_PRECOMMIT, bid) for idx, v in enumerate(vs.validators)]
    sb = votes[0].sign_bytes(CHAIN_ID)  # identical for every validator
    jobs = [(seed_of[vote.validator_address], sb) for vote in votes]
    sigs = pool.starmap(ed.sign, jobs, chunksize=64) if pool is not None else [ed.sign(*j) for j in jobs]
    return Commit(bid, [vote.with_signature(SignatureEd25519(sig)) for vote, sig in zip(votes, sigs)])


def tampered_refusal(state, block) -> str:
    """validate_block on a copy of `block` whose LastCommit is tampered, which
    must raise InvalidBlockError: a forged precommit in a full commit, a
    dropped signer (its bit and its R) in an aggregate one."""
    from tendermint_tpu_torch.crypto.keys import SignatureEd25519
    from tendermint_tpu_torch.state import validate_block
    from tendermint_tpu_torch.state.execution import InvalidBlockError
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit
    from tendermint_tpu_torch.types.block import Block

    bad = Block.from_bytes(block.to_bytes())
    lc = bad.last_commit
    if isinstance(lc, AggregateCommit):
        signers = lc.signers.copy()
        signers.set_index(signers.indices()[0], False)
        bad.last_commit = AggregateCommit(lc.block_id, lc.height(), lc.round_(), signers, lc.rs[1:], lc.s_agg)
    else:
        pre = lc.precommits[7]
        raw = bytearray(pre.signature.raw)
        raw[5] ^= 0x20
        lc.precommits[7] = pre.with_signature(SignatureEd25519(bytes(raw)))
        lc._hash = None
    bad.header.last_commit_hash = bad.last_commit.hash()
    bad.fill_header()
    try:
        validate_block(state, bad)
    except InvalidBlockError as exc:
        return str(exc)[:80]
    raise AssertionError(f"height {block.header.height}: a tampered LastCommit was accepted")


class batch_recorder:
    """The gate's verifier, with the size of every batch the SigBatcher
    hands it recorded (the gate batches by time, so its batch count varies
    between runs), and the seconds the gate's thread spends in the
    verifier: dispatching each batch and resolving its verdicts."""

    def __init__(self, verifier):
        self.verifier = verifier
        self.sizes: list[int] = []
        self.seconds = 0.0

    def verify_batch_async(self, items):
        self.sizes.append(len(items))
        t0 = time.perf_counter()
        resolve = self.verifier.verify_batch_async(items)
        self.seconds += time.perf_counter() - t0

        def timed_resolve():
            t1 = time.perf_counter()
            try:
                return resolve()
            finally:
                self.seconds += time.perf_counter() - t1

        return timed_resolve

    def take(self) -> tuple[list[int], float]:
        out = (self.sizes, self.seconds)
        self.sizes, self.seconds = [], 0.0
        return out


class exec_chain:
    """One chain of the exec_chain cell, wired by hand as node/node.py wires
    a node, in a temp directory of its own: sqlite `state`, `blockstore` and
    `tx_index` DBs (the default db_backend), State.get_state with a
    KVTxIndexer, a SignedKVStoreApp (verify_in_app off, its tree hashing
    through `hasher`, its block verify through `verifier`, APP_SHARDS
    shards) behind AppConns(LocalClientCreator), and a Mempool rooted in the
    directory with a WAL, gated by SigBatcher(verifier, parse_sig_tx).
    `agg_default`, when given, is installed as the gateway's default
    verifier around apply_block (an aggregate LastCommit verifies there)."""

    def __init__(self, doc, verifier, hasher, agg_default=None):
        from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp, parse_sig_tx
        from tendermint_tpu_torch.blockchain import BlockStore
        from tendermint_tpu_torch.config import test_config
        from tendermint_tpu_torch.libs.db import db_provider
        from tendermint_tpu_torch.libs.events import EventSwitch
        from tendermint_tpu_torch.mempool.mempool import Mempool, SigBatcher
        from tendermint_tpu_torch.proxy import AppConns, LocalClientCreator
        from tendermint_tpu_torch.state import State
        from tendermint_tpu_torch.state.txindex import KVTxIndexer

        self.doc, self.verifier, self.hasher, self.agg_default = doc, verifier, hasher, agg_default
        self.root = tempfile.mkdtemp(prefix="exec-chain-")
        self.dbs = {n: db_provider(n, "sqlite", self.root) for n in ("state", "blockstore", "tx_index")}
        self.state = State.get_state(self.dbs["state"], doc)
        self.state.tx_indexer = KVTxIndexer(self.dbs["tx_index"])
        self.store = BlockStore(self.dbs["blockstore"])
        self.app = SignedKVStoreApp(verify_in_app=False)
        self.rec = wave_recorder(hasher)
        self.app.tree.hasher = self.rec
        self.app.deliver_verifier = verifier
        self.app.shards = APP_SHARDS
        self.conns = AppConns(LocalClientCreator(self.app))
        self.conns.start()
        self.cfg = test_config().mempool
        self.cfg.root_dir = self.root
        self.gate = batch_recorder(verifier)
        self.batcher = SigBatcher(self.gate, parse_sig_tx)
        self.mempool = Mempool(self.cfg, self.conns.mempool(), sig_batcher=self.batcher)
        self.mempool.init_wal()
        self.evsw = EventSwitch()
        self.seen = None  # the last height's seen commit

    def burst(self, txs: list[bytes], forged: list[int]) -> dict:
        """check_tx every tx, then wait until the pool holds the valid ones
        and every tx has its answer."""
        codes: dict[int, int] = {}
        want = len(txs) - len(forged)
        t0 = time.perf_counter()
        for i, tx in enumerate(txs):
            self.mempool.check_tx(tx, cb=lambda res, i=i: codes.__setitem__(i, res.code))
        deadline = time.monotonic() + EXEC_DRAIN_S
        while self.mempool.size() < want or len(codes) < len(txs):
            if time.monotonic() > deadline:
                raise AssertionError(f"burst: {self.mempool.size()} in the pool, {len(codes)} answered")
            time.sleep(0.0005)
        wall = time.perf_counter() - t0
        sizes, verify_s = self.gate.take()
        return {"gate_s": wall, "gate_verify_s": verify_s, "sizes": sizes,
                "refused": sorted(i for i, c in codes.items() if c)}

    def build(self, height: int):
        """Reap and build the height's block as consensus builds it: the
        LastCommit in the format the schedule requires (consensus/state.py
        _commit_for_proposal), the Hasher wired as make_block_with wires it."""
        from tendermint_tpu_torch.types.agg_commit import AggregateCommit
        from tendermint_tpu_torch.types.block import empty_commit

        st = self.state
        reaped = self.mempool.reap(self.doc.consensus_params.block_size.max_txs)
        if height == 1:
            last = empty_commit()
        elif self.doc.aggregate_commits_at(height):
            last = AggregateCommit.from_commit(self.seen, CHAIN_ID, st.last_validators)
        else:
            last = self.seen
        t0 = time.perf_counter()
        block, parts = make_block_with(
            self.hasher, reaped, (st.validators, st.last_block_id, last),
            self.doc.consensus_params.block_gossip.block_part_size_bytes, height=height,
            app_hash=st.app_hash, time_ns=BLOCK_TIME_NS + height * 10**9)
        _sync()
        return block, parts, time.perf_counter() - t0

    def apply(self, block, parts) -> dict:
        """apply_block with the gateway's batch verifier, each stage clocked:
        validate_block, the deliver (BeginBlock, the block's DeliverTx,
        EndBlock), the app commit with the mempool update, and the state
        save with indexing."""
        from tendermint_tpu_torch.libs.events import EventCache
        from tendermint_tpu_torch.ops import gateway
        from tendermint_tpu_torch.state import State, apply_block
        from tendermint_tpu_torch.state import execution

        saved = gateway._default_verifier
        if self.agg_default is not None:
            gateway._default_verifier = self.agg_default
        cache = EventCache(self.evsw)
        try:
            with stage_clock(validate=(execution, "validate_block"),
                             deliver=(execution, "exec_block_on_proxy_app"),
                             commit=(execution, "commit_state_update_mempool"),
                             index=(execution, "index_txs"),
                             responses=(State, "save_abci_responses"), save=(State, "save")) as clk:
                t0 = time.perf_counter()
                apply_block(self.state, cache, self.conns.consensus(), block, parts.header(), self.mempool,
                            batch_verifier=self.verifier.commit_batch_verifier())
                _sync()
                wall = time.perf_counter() - t0
        finally:
            gateway._default_verifier = saved
        cache.flush()
        sec = clk.seconds
        return {"apply_s": wall, "validate_s": sec["validate"], "deliver_s": sec["deliver"],
                "app_commit_s": sec["commit"],
                "save_and_index_s": sec["index"] + sec["responses"] + sec["save"]}

    def save(self, seed_of, block, parts, pool=None) -> float:
        """Sign the height's precommits (in `pool` when given), then
        save_block with them as the seen commit."""
        st = self.state
        self.seen = sign_commit(st.last_validators, seed_of, block.header.height, st.last_block_id, pool)
        t0 = time.perf_counter()
        self.store.save_block(block, parts, self.seen)
        return time.perf_counter() - t0

    def records(self, height: int, sample: list[bytes]) -> dict:
        """What a node holds for `height`: the stored block, meta and
        commits, the state and the last ABCI responses, and the tx-index
        entries of `sample`."""
        from tendermint_tpu_torch.types.tx import tx_hash

        s = self.store
        return {
            "block": s.load_block(height).to_bytes(), "meta": s.load_block_meta(height).to_json(),
            "commit": s.load_block_commit(height - 1).to_json(), "seen": s.load_seen_commit(height).to_json(),
            "state": self.state.bytes_(), "app_hash": self.state.app_hash,
            "responses": self.state.load_abci_responses().bytes_(),
            "index": [self.state.tx_indexer.get(tx_hash(tx)).to_json() for tx in sample],
        }

    def wal(self) -> bytes:
        with open(self.cfg.wal_dir(), "rb") as f:
            return f.read()

    def close(self) -> None:
        self.batcher.stop()
        self.mempool.close_wal()
        self.conns.stop()
        for db in self.dbs.values():
            db.close()

    def discard(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


def exec_phase(name, power, vs, seed_of, bursts) -> dict:
    """Phase 27: the execution path on the card, in process (no daemon
    socket; the default Verifier and Hasher on the local route, asserted).
    An exec_chain on `default_verifier()` and `default_hasher()` and one on
    the host reference (host_hasher(), a Verifier whose gate sends every
    lane to the native CPU floor, installed as the default around its
    apply_block) each take EXEC_HEIGHTS heights: the burst through
    check_tx, reap, the block build, apply_block, the precommits and
    save_block. Launches are reset just before each stage and read just
    after. Then the sqlite files reopen (the restart) and a fresh card app
    replays the stored blocks through exec_commit_block (the handshake).
    Returns what phase 28 needs and the launches a kernel over these paths."""
    import torch

    from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp
    from tendermint_tpu_torch.blockchain import BlockStore
    from tendermint_tpu_torch.libs.db import db_provider
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops.gateway import Verifier
    from tendermint_tpu_torch.proxy import AppConns, LocalClientCreator
    from tendermint_tpu_torch.state import State, exec_commit_block
    from tendermint_tpu_torch.types import tx as ptx

    tag = {"card": name, "power_limit": power}
    dev_type = torch.device(DEVICE).type
    doc = exec_genesis(vs)
    total = dict.fromkeys(("b1", "dsm", "ripemd160", "merkle_tree"), 0)
    sample_rng = np.random.default_rng(SEED + 28)
    with routed_to():
        gateway._default_verifier = gateway._default_hasher = None
        verifier = gateway.default_verifier()
        hasher = gateway.default_hasher()
        if verifier.kernel != "f32p" or verifier.device is None or verifier.device.type != dev_type:
            raise AssertionError(f"default Verifier: kernel {verifier.kernel}, device {verifier.device}")
        if hasher._route != "local" or hasher.device is None or hasher.device.type != dev_type:
            raise AssertionError(f"default Hasher: route {hasher._route}, device {hasher.device}")
        ref_v = Verifier(min_tpu_batch=APP_REF_GATE, device="cpu")
        chains = {"card": exec_chain(doc, verifier, hasher),
                  "host": exec_chain(doc, ref_v, host_hasher(), agg_default=ref_v)}
        gate_min = verifier.min_tpu_batch
        records = {"card": [], "host": []}
        runs = {"card": [], "host": []}  # phase 28's rows, a height each
        app_hashes = []
        try:
            for height, burst in enumerate(bursts, 1):
                txs, forged = burst["txs"], burst["forged"]
                for label, ch in chains.items():
                    v, app = ch.verifier, ch.app
                    v0, calls0 = v.stats(), app.check_tx_calls
                    gc.collect()
                    reset_launches()
                    gate = ch.burst(txs, forged)
                    l_gate = read_launches()
                    v1 = v.stats()
                    sigs = {k: v1[k] - v0[k] for k in ("tpu_batches", "tpu_sigs", "cpu_sigs")}
                    if gate["refused"] != forged:
                        raise AssertionError(f"{label} height {height}: refused {gate['refused']}, forged {forged}")
                    if app.check_tx_calls - calls0 != len(txs) - len(forged):
                        raise AssertionError(f"{label} height {height}: {app.check_tx_calls - calls0} CheckTx calls")
                    sizes = gate["sizes"]
                    wide = [n for n in sizes if n >= gate_min]
                    if sum(sizes) != len(txs):
                        raise AssertionError(f"{label} height {height}: gate batches {sizes}")
                    if label == "card":
                        want = {"tpu_batches": len(wide), "tpu_sigs": sum(wide), "cpu_sigs": len(txs) - sum(wide)}
                        if sigs != want or not wide:
                            raise AssertionError(f"card height {height}: gate {sigs}, batches {sizes}")
                        _launch_delta(l_gate, {"b1": len(wide)}, f"height {height} gate")
                        total["b1"] += l_gate["b1"]
                    else:
                        if sigs != {"tpu_batches": 0, "tpu_sigs": 0, "cpu_sigs": len(txs)}:
                            raise AssertionError(f"host height {height}: gate {sigs}")
                        _launch_delta(l_gate, {}, f"host height {height} gate")

                    reset_launches()
                    block, parts, make_s = ch.build(height)
                    l_build = read_launches()
                    if label == "card":
                        _launch_delta(l_build, {"ripemd160": 2, "merkle_tree": 2}, f"height {height} build")
                        total["ripemd160"] += 2
                        total["merkle_tree"] += 2
                    else:
                        _launch_delta(l_build, {}, f"host height {height} build")
                    refusal = tampered_refusal(ch.state, block) if label == "card" and height >= 2 else None

                    v0 = v.stats()
                    ch.rec.take()
                    reset_launches()
                    times = ch.apply(block, parts)
                    l_apply = read_launches()
                    widths, _ = ch.rec.take()
                    v1 = v.stats()
                    d = {k: v1[k] - v0[k] for k in ("tpu_sigs", "cpu_sigs", "agg_lanes_device", "agg_lanes_cpu")}
                    full = height == 2
                    agg = doc.aggregate_commits_at(height) and height > 1
                    n_vals = vs.size()
                    if label == "card":
                        want = {"tpu_sigs": len(block.data.txs) + (n_vals if full else 0), "cpu_sigs": 0,
                                "agg_lanes_device": n_vals + 1 if agg else 0, "agg_lanes_cpu": 0}
                        if d != want:
                            raise AssertionError(f"card height {height}: apply verify {d}, expected {want}")
                        _launch_delta(l_apply, {"b1": 1 + full, "dsm": int(agg), "ripemd160": len(widths)},
                                      f"height {height} apply")
                        if not widths:
                            raise AssertionError(f"height {height}: the app hashed nothing on the card")
                        for k in ("b1", "dsm", "ripemd160"):
                            total[k] += l_apply[k]
                    else:
                        _launch_delta(l_apply, {}, f"host height {height} apply")
                    if ch.mempool.size() != 0:
                        raise AssertionError(f"{label} height {height}: {ch.mempool.size()} txs left in the pool")
                    save_s = ch.save(seed_of, block, parts)
                    row = {"gate_s": gate["gate_s"], "gate_verify_s": gate["gate_verify_s"],
                           "gate_batches": len(sizes), "make_block_s": make_s, **times, "save_block_s": save_s}
                    row["height_s"] = row["gate_s"] + make_s + times["apply_s"] + save_s
                    runs[label].append(row)
                    if label == "card":  # the host's block is the same: checked below
                        picks = sample_rng.choice(len(block.data.txs), size=EXEC_INDEX_SAMPLE, replace=False)
                        sample = [block.data.txs[i] for i in sorted(picks)]
                    records[label].append(ch.records(height, sample))
                    log({"phase": "exec_chain", **tag, "chain": label, "height": height,
                         "txs": len(block.data.txs), "refused": len(gate["refused"]), "gate_batches": sizes,
                         "gate_sigs": sigs, "parts": parts.total, "block_bytes": len(records[label][-1]["block"]),
                         "last_commit": block.commit_format() if height > 1 else None,
                         "launches": {"gate": l_gate, "build": l_build, "apply": l_apply},
                         "commit_waves_k1": widths, "refusal": refusal, "gate_s": gate["gate_s"],
                         "gate_verify_s": gate["gate_verify_s"], "make_block_s": make_s, **times, "save_block_s": save_s,
                         "app_hash": ch.state.app_hash.hex()})
                if records["card"][-1] != records["host"][-1]:
                    diff = [k for k in records["card"][-1] if records["card"][-1][k] != records["host"][-1][k]]
                    raise AssertionError(f"height {height}: the card chain differs from the host's in {diff}")
                app_hashes.append(chains["card"].state.app_hash)
            if chains["card"].wal() != chains["host"].wal():
                raise AssertionError("the mempool WALs differ")
            wal_lines = chains["card"].wal().count(b"\n")
            if hasher.stats()["cpu_leaves"] != 0:
                raise AssertionError(f"the Hasher hashed {hasher.stats()['cpu_leaves']} leaves on the host")
            live = {label: ch.state.bytes_() for label, ch in chains.items()}
            blocks = [chains["card"].store.load_block(h) for h in range(1, len(bursts) + 1)]
        finally:
            for ch in chains.values():
                ch.close()

        # the restart: the sqlite files reopen to the same state and blocks
        card = chains["card"]
        dbs = {n: db_provider(n, "sqlite", card.root) for n in ("state", "blockstore")}
        try:
            reloaded = State.load_state(dbs["state"], doc)
            store = BlockStore(dbs["blockstore"])
            if reloaded is None or reloaded.bytes_() != live["card"]:
                raise AssertionError("restart: the reloaded state differs from the live one")
            if store.height() != len(bursts) or [store.load_block(h).to_bytes() for h in range(1, len(bursts) + 1)] \
                    != [b.to_bytes() for b in blocks]:
                raise AssertionError(f"restart: the block store holds {store.height()} other blocks")
        finally:
            for db in dbs.values():
                db.close()

        # the handshake's replay on a fresh card app
        app = SignedKVStoreApp(verify_in_app=False)
        rec = wave_recorder(hasher)
        app.tree.hasher = rec
        app.deliver_verifier = verifier
        app.shards = APP_SHARDS
        conns = AppConns(LocalClientCreator(app))
        conns.start()
        replayed = []
        reset_launches()
        t0 = time.perf_counter()
        for block in blocks:
            replayed.append(exec_commit_block(conns.consensus(), block))
        _sync()
        replay_s = time.perf_counter() - t0
        l_replay = read_launches()
        widths, _ = rec.take()
        conns.stop()
        if replayed != app_hashes:
            raise AssertionError("replay: the fresh app's hashes differ from the chain's")
        _launch_delta(l_replay, {"b1": len(blocks), "ripemd160": len(widths)}, "replay")
        total["b1"] += l_replay["b1"]
        total["ripemd160"] += l_replay["ripemd160"]
        for ch in chains.values():
            ch.discard()
        ptx.set_batch_tx_root(None)
        log({"phase": "exec_plane", **tag, "validators": vs.size(), "heights": len(bursts),
             "upgrade_height": EXEC_UPGRADE_HEIGHT, "txs_per_height": [len(b["txs"]) for b in bursts],
             "app_hashes": [h.hex() for h in app_hashes], "wal_lines": wal_lines,
             "restart": "equal", "replay_s": replay_s, "replay_launches": l_replay,
             "verifier": verifier.stats(), "launches": total,
             "route": {"verify": verifier.kernel, "hash": hasher._route}})
    return {"doc": doc, "vs": vs, "seed_of": seed_of, "bursts": bursts, "records": records["card"],
            "runs": {label: [rows] for label, rows in runs.items()}, "launches": total}


EXEC_STAGES = ("gate_s", "gate_verify_s", "make_block_s", "validate_s", "deliver_s", "app_commit_s", "save_and_index_s",
               "apply_s", "save_block_s")


def exec_time(name, power, ctx) -> None:
    """Phase 28: phase 27's card and host chains, a height at a time (the
    smoke's clock leaves no second pair of chains: PERF.md §4): the burst
    from the first check_tx to drained, make_block, validate_block (height
    2 on B1, height 3 on dsm), apply_block split into the deliver, the app
    commit and the state save with indexing, and save_block, each height
    after a full collection of the heap."""
    tag = {"card": name, "power_limit": power}
    doc, bursts, runs = ctx["doc"], ctx["bursts"], ctx["runs"]
    for height in range(1, len(bursts) + 1):
        best = {label: min((r[height - 1] for r in rows), key=lambda row: row["height_s"])
                for label, rows in runs.items()}
        stage_best = {label: {k: min(r[height - 1][k] for r in rows) for k in EXEC_STAGES + ("height_s",)}
                      for label, rows in runs.items()}
        log({"phase": "exec_chain_time", **tag, "height": height,
             "last_commit": None if height == 1 else ("aggregate" if doc.aggregate_commits_at(height) else "full"),
             "card_best": best["card"], "host_best": best["host"],
             "card_stage_best": stage_best["card"], "host_stage_best": stage_best["host"],
             "speedup": best["host"]["height_s"] / best["card"]["height_s"],
             "stage_speedup": {k: stage_best["host"][k] / stage_best["card"][k] for k in EXEC_STAGES
                               if stage_best["card"][k] > 0},
             "card_runs": [r[height - 1] for r in runs["card"]],
             "host_runs": [r[height - 1] for r in runs["host"]]})


# -- phases 29-30: the transport and fast sync ----------------------------------------


def make_fastsync_inputs(pool, rng) -> list[dict]:
    """The fast_sync chain's bursts, from their own generator: FASTSYNC_HEIGHTS
    of them, the first all new keys, then FASTSYNC_BLOCK (see make_bursts)."""
    return make_bursts(pool, rng, FASTSYNC_HEIGHTS, FASTSYNC_FIRST_BLOCK, FASTSYNC_BLOCK,
                       FASTSYNC_VALUE_BYTES, FASTSYNC_SIGNERS, b"fsync-%07d")


def consensus_stand_in():
    """The CONSENSUS reactor's place on a switch: the fast-sync reactor hands
    over to it (`switch_to_consensus`, reached duck-typed as on a node); it
    records each state it is handed, as bytes."""
    from tendermint_tpu_torch.p2p import Reactor

    class ConsensusStandIn(Reactor):
        def __init__(self):
            self.switched: list[bytes] = []

        def start(self):
            pass

        def stop(self):
            pass

        def get_channels(self):
            return []

        def switch_to_consensus(self, state):
            self.switched.append(state.bytes_())

    return ConsensusStandIn()


class p2p_node:
    """A switch wired as node/node.py wires one: the p2p config's rates and
    flush throttle in the MConnConfig of every peer (secret connections on),
    a listener on 127.0.0.1 port 0, NodeInfo with the genesis schedule, a
    BlockchainReactor on `state.copy()` and `store` (`reactor_kw` as
    node/node.py:332-341 passes them) and the consensus stand-in. Every
    stop_peer_for_error is recorded. start() starts the switch."""

    def __init__(self, doc, state, store, app_conn, fast_sync: bool, moniker: str, **reactor_kw):
        from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
        from tendermint_tpu_torch.config.config import P2PConfig
        from tendermint_tpu_torch.p2p import MConnConfig, NodeInfo, PeerConfig, Switch
        from tendermint_tpu_torch.p2p.listener import Listener
        from tendermint_tpu_torch.p2p.node_info import default_version
        from tendermint_tpu_torch.version import VERSION

        cfg = P2PConfig(**FASTSYNC_P2P)
        self.sw = Switch(cfg, PeerConfig(mconfig=MConnConfig(
            send_rate=float(cfg.send_rate), recv_rate=float(cfg.recv_rate),
            flush_throttle=cfg.flush_throttle_timeout)))
        self.bc = BlockchainReactor(state.copy(), app_conn, store, fast_sync, **reactor_kw)
        self.consensus = consensus_stand_in()
        self.sw.add_reactor("BLOCKCHAIN", self.bc)
        self.sw.add_reactor("CONSENSUS", self.consensus)
        self.listener = Listener("127.0.0.1:0")
        self.sw.add_listener(self.listener)
        self.sw.set_node_info(NodeInfo(
            pub_key=self.sw.node_priv_key.pub_key(), moniker=moniker, network=doc.chain_id,
            version=default_version(VERSION), listen_addr=str(self.listener.internal_address()),
            other=["consensus_version=v1", f"commit_schedule={doc.schedule_string()}"]))
        self.stops: list[tuple[str, str]] = []
        stop_peer = self.sw.stop_peer_for_error

        def recording_stop(peer, reason):
            self.stops.append((peer.id(), str(reason)))
            stop_peer(peer, reason)

        self.sw.stop_peer_for_error = recording_stop

    def start(self) -> "p2p_node":
        self.sw.start()
        return self

    def node_id(self) -> str:
        return self.sw.node_priv_key.pub_key().address().hex()

    def dial(self, port: int):
        from tendermint_tpu_torch.p2p import NetAddress

        return self.sw.dial_peer_with_address(NetAddress("127.0.0.1", port))

    def close(self) -> None:
        self.sw.stop()


class tampered_store:
    """A BlockStore whose block `height` comes back with one signature of
    its LastCommit flipped (precommit 7, bit 5 of byte 5)."""

    def __init__(self, store, height: int):
        self.store, self.height_tampered = store, height

    def __getattr__(self, attr):
        return getattr(self.store, attr)

    def load_block(self, height: int):
        from tendermint_tpu_torch.crypto.keys import SignatureEd25519

        block = self.store.load_block(height)
        if height == self.height_tampered:
            lc = block.last_commit
            pre = lc.precommits[7]
            raw = bytearray(pre.signature.raw)
            raw[5] ^= 0x20
            lc.precommits[7] = pre.with_signature(SignatureEd25519(bytes(raw)))
            lc._hash = None
        return block


def serve_chain(root: str, doc_json, tamper_height: int, conn) -> None:
    """A serving node in a process of its own: the sqlite `state` and
    `blockstore` under `root` (a node's files), a p2p_node with a
    BlockchainReactor(fast_sync=False), and with `tamper_height` the
    tampered_store in front of the block store. Sends (port, node id), then
    serves until told to stop."""
    from tendermint_tpu_torch.blockchain import BlockStore
    from tendermint_tpu_torch.libs.db import db_provider
    from tendermint_tpu_torch.state import State
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    doc = GenesisDoc.from_json(doc_json)
    dbs = {n: db_provider(n, "sqlite", root) for n in ("state", "blockstore")}
    store = BlockStore(dbs["blockstore"])
    node = p2p_node(doc, State.load_state(dbs["state"], doc),
                    tampered_store(store, tamper_height) if tamper_height else store, None, False,
                    "C" if tamper_height else "A").start()
    try:
        conn.send((node.listener.internal_address().port, node.node_id()))
        conn.recv()
        conn.send(node.stops)
    finally:
        node.close()
        for db in dbs.values():
            db.close()


class serving_process:
    """serve_chain in a spawned process: its port, node id, and close()
    (the stop message, then join; killed after DEVD_STOP_S)."""

    def __init__(self, root: str, doc, tamper_height: int = 0):
        self._spawn(serve_chain, (root, doc.to_json(), tamper_height))
        self.port, self.node_id = self._first_message()

    def _spawn(self, target, args: tuple) -> None:
        """target(*args, conn) in a spawned process."""
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=target, args=(*args, child), daemon=True)
        self.proc.start()
        self.stops = None

    def _first_message(self):
        if not self.conn.poll(FASTSYNC_SYNC_S):
            self.proc.kill()
            raise AssertionError("the serving process did not start")
        return self.conn.recv()

    def close(self) -> None:
        try:
            self.conn.send("stop")
            if self.conn.poll(DEVD_STOP_S):
                self.stops = self.conn.recv()
        except (OSError, EOFError):
            pass
        self.proc.join(DEVD_STOP_S)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()


class fastsync_node:
    """Node B of the fast_sync cell, empty, wired by hand as node/node.py
    wires a node, in a temp directory of its own: sqlite `state`,
    `blockstore` and `tx_index`, State.get_state with a KVTxIndexer, a
    SignedKVStoreApp (verify_in_app off, its block verify through
    `verifier`, its tree hashing through `hasher`, APP_SHARDS shards) behind
    AppConns, and a p2p_node whose BlockchainReactor takes the verifier's
    commit_batch_verifier and verify_batch_async (through a batch_recorder)
    and the hasher's part_leaf_hashes and part_set_tree. The post-apply hook
    records when each block was applied; close() waits for the reactor's
    sync loop to end before it closes the stores."""

    def __init__(self, doc, verifier, hasher, label: str):
        from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp
        from tendermint_tpu_torch.blockchain import BlockStore
        from tendermint_tpu_torch.libs.db import db_provider
        from tendermint_tpu_torch.proxy import AppConns, LocalClientCreator
        from tendermint_tpu_torch.state import State
        from tendermint_tpu_torch.state.txindex import KVTxIndexer

        self.doc, self.verifier, self.hasher = doc, verifier, hasher
        self.root = tempfile.mkdtemp(prefix="fastsync-")
        self.dbs = {n: db_provider(n, "sqlite", self.root) for n in ("state", "blockstore", "tx_index")}
        self.state = State.get_state(self.dbs["state"], doc)
        self.state.tx_indexer = KVTxIndexer(self.dbs["tx_index"])
        self.store = BlockStore(self.dbs["blockstore"])
        self.app = SignedKVStoreApp(verify_in_app=False)
        self.rec = wave_recorder(hasher)
        self.app.tree.hasher = self.rec
        self.app.deliver_verifier = verifier
        self.app.shards = APP_SHARDS
        self.conns = AppConns(LocalClientCreator(self.app))
        self.conns.start()
        self.gate = batch_recorder(verifier)
        self.applied: list[float] = []
        self.node = p2p_node(doc, self.state, self.store, self.conns.consensus(), True, label,
                             batch_verifier=verifier.commit_batch_verifier(),
                             async_batch_verifier=self.gate.verify_batch_async,
                             part_hasher=hasher.part_leaf_hashes, part_tree_hasher=hasher.part_set_tree,
                             post_apply_hook=lambda state, block: self.applied.append(time.perf_counter()))
        self.loop_done = threading.Event()
        loop = self.node.bc._pool_routine

        def pool_routine():
            try:
                loop()
            finally:
                self.loop_done.set()

        self.node.bc._pool_routine = pool_routine
        self.node.start()

    def sync(self, *serving: serving_process, until_height: int | None = None) -> dict:
        """Dial the serving nodes in order (after the first, once it is the
        pool's peer), then wait for the switch to consensus, or with
        `until_height` for the store to reach it, or for the sync's error,
        each wait within FASTSYNC_SYNC_S. The tx-root hook and the gateway's
        default verifier (an aggregate LastCommit's) are this node's, as
        node/node.py installs them, for the run; apply_block's stages are
        clocked (validate_block, the deliver, the app commit, the state
        save with indexing)."""
        from tendermint_tpu_torch.ops import gateway
        from tendermint_tpu_torch.state import State, execution
        from tendermint_tpu_torch.types import tx as ptx

        bc = self.node.bc
        saved = gateway._default_verifier
        gateway._default_verifier = self.verifier
        ptx.set_batch_tx_root(self.hasher.tx_merkle_root)
        done = (lambda: self.node.consensus.switched) if until_height is None else \
            (lambda: self.store.height() >= until_height)
        try:
            with stage_clock(validate=(execution, "validate_block"),
                             deliver=(execution, "exec_block_on_proxy_app"),
                             commit=(execution, "commit_state_update_mempool"),
                             index=(execution, "index_txs"),
                             save=(State, "save"), responses=(State, "save_abci_responses")) as clk:
                t0 = time.perf_counter()
                for i, peer in enumerate(serving):
                    if i:
                        first = serving[0].node_id
                        wait_for(lambda: first in bc.pool.peers, FASTSYNC_SYNC_S, "the first peer's status")
                    self.node.dial(peer.port)
                wait_for(lambda: done() or bc.sync_error is not None, FASTSYNC_SYNC_S,
                         f"the sync (store at {self.store.height()})")
                _sync()
        finally:
            gateway._default_verifier = saved
            ptx.set_batch_tx_root(None)
        if bc.sync_error is not None:
            raise AssertionError(f"fast sync stopped: {bc.sync_error!r}")
        blocks = len(self.applied)
        wall = self.applied[-1] - t0
        stages = dict(bc.stage_s)
        # every part set is rebuilt inside the dispatch of the window that
        # first holds its block: part_hash is a share of dispatch
        sec = clk.seconds
        return {"blocks": blocks, "wall_s": wall, "blocks_per_s": blocks / wall, "stage_s": stages,
                "unaccounted_s": wall - sum(v for k, v in stages.items() if k != "part_hash"),
                "apply_split_s": {"validate": sec["validate"], "deliver": sec["deliver"], "app_commit": sec["commit"],
                                  "save_and_index": sec["index"] + sec["save"] + sec["responses"]}}

    def close(self) -> None:
        self.node.close()
        if not self.loop_done.wait(FASTSYNC_SYNC_S):
            raise AssertionError("the fast-sync loop did not end")
        self.conns.stop()
        for db in self.dbs.values():
            db.close()
        shutil.rmtree(self.root, ignore_errors=True)


def wait_for(cond, seconds: float, what: str) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {seconds} s")
        time.sleep(0.02)


def fastsync_records(store, state, target: int, sample: list[bytes], seen=None) -> dict:
    """What a node holds for heights 1..target: block bytes, metas, each
    block's LastCommit as stored, the seen commits (`seen(h)`, or the
    store's), and, with `state`, the state's bytes and app hash and the
    tx-index entries of `sample`."""
    from tendermint_tpu_torch.types.tx import tx_hash

    seen = seen or (lambda h: store.load_seen_commit(h))
    out = {
        "blocks": [store.load_block(h).to_bytes() for h in range(1, target + 1)],
        "metas": [store.load_block_meta(h).to_json() for h in range(1, target + 1)],
        "commits": [store.load_block_commit(h).to_json() for h in range(1, target)],
        "seen": [seen(h).to_json() for h in range(1, target + 1)],
    }
    if state is not None:
        out.update(state=state.bytes_(), app_hash=state.app_hash,
                   index=[state.tx_indexer.get(tx_hash(tx)).to_json() for tx in sample])
    return out


def fastsync_expected(doc, target: int, groups: list[int], waves: list[int], n_vals: int,
                      delivered: int) -> dict:
    """The launches and lanes a card sync of heights 1..target implies: B1
    once a group of full commits (the reactor's dispatches), once a full
    LastCommit checked at apply (blocks 2 up to the upgrade) and once a
    deliver; dsm once an aggregate LastCommit proving a height and once an
    aggregate LastCommit checked at apply; K1 and K3 once a part set
    rebuilt and once a tx root (validate_block's data hash, through the
    Hasher the tx-root hook names), K1 once a wave the app hands its
    Hasher. `delivered` is the synced blocks' txs, each a deliver lane."""
    full_apply = sum(not doc.aggregate_commits_at(h) for h in range(2, target + 1))
    agg_apply = (target - 1) - full_apply
    agg_proof = sum(doc.aggregate_commits_at(h + 1) for h in range(1, target + 1))
    return {
        "launches": {"b1": len(groups) + full_apply + target, "dsm": agg_proof + agg_apply,
                     "ripemd160": 2 * target + len(waves), "merkle_tree": 2 * target},
        "lanes": {"tpu_sigs": sum(groups) + n_vals * full_apply + delivered, "cpu_sigs": 0,
                  "agg_lanes_device": (n_vals + 1) * (agg_proof + agg_apply), "agg_lanes_cpu": 0},
    }


def fastsync_phase(name, power, vs, seed_of, bursts) -> dict:
    """Phase 29: the transport and fast sync on the card. Node A (an
    exec_chain on the default Verifier and Hasher) builds FASTSYNC_HEIGHTS
    heights of `bursts` into its sqlite files, which a serving_process
    serves (a node of its own: BlockchainReactor(fast_sync=False)). In this
    process (no daemon socket), node B (a fastsync_node on
    Verifier(device=DEVICE) and a fresh Hasher(device=DEVICE)) dials A over
    TCP, both on secret connections, and syncs every height the pool can
    prove (A's less one: the last block waits for its successor's
    LastCommit), then switches to consensus once; its launches are set to 0
    just before the dial and read just after. The host reference B' (a
    Verifier whose gate sends every lane to the native CPU floor, installed
    as the default verifier for its aggregate LastCommits, and
    host_hasher()) syncs the same way and launches nothing. Both equal A's
    records, state and app hash. Then a tampered peer C (A's files,
    block FASTSYNC_TAMPER_HEIGHT + 1's LastCommit with a flipped
    signature) is dialed before A by a fresh card node, which syncs past
    the tampered height: C is stopped for "sent invalid block" exactly
    once, A stays, and the blocks stored are A's. Returns what phase 30
    needs (A's server is left running for it) and the launches."""
    import torch

    from tendermint_tpu_torch.crypto.x25519 import resolve_backend
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops.gateway import Hasher, Verifier
    from tendermint_tpu_torch.types import tx as ptx

    tag = {"card": name, "power_limit": power}
    dev_type = torch.device(DEVICE).type
    doc = exec_genesis(vs, FASTSYNC_UPGRADE_HEIGHT)
    n_vals = vs.size()
    part_size = doc.consensus_params.block_gossip.block_part_size_bytes
    with routed_to():
        gateway._default_verifier = gateway._default_hasher = None
        a = exec_chain(doc, gateway.default_verifier(), gateway.default_hasher())
        t0 = time.perf_counter()
        try:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(processes=min(8, os.cpu_count() or 1)) as pool:
                for height, burst in enumerate(bursts, 1):
                    gate = a.burst(burst["txs"], burst["forged"])
                    if gate["refused"] != burst["forged"]:
                        raise AssertionError(f"A height {height}: refused {gate['refused']}")
                    block, parts, _ = a.build(height)
                    if parts.total < a.hasher.min_tpu_batch:
                        raise AssertionError(f"A height {height}: {parts.total} parts, under the Hasher's gate")
                    a.apply(block, parts)
                    a.save(seed_of, block, parts, pool)
                    if height == len(bursts) - 1:
                        target_state = a.state.bytes_(), a.state.app_hash
            ptx.set_batch_tx_root(None)
            height_a = a.store.height()
            target = height_a - 1
            blocks = [a.store.load_block(h) for h in range(1, height_a + 1)]
            sample_rng = np.random.default_rng(SEED + 29)
            synced_txs = [tx for b in blocks[:target] for tx in b.data.txs]
            sample = [synced_txs[i] for i in sorted(sample_rng.choice(len(synced_txs), EXEC_INDEX_SAMPLE,
                                                                      replace=False))]
            want = fastsync_records(a.store, a.state, target, sample,
                                    seen=lambda h: a.store.load_block(h + 1).last_commit)
            want["state"], want["app_hash"] = target_state
        finally:
            a.close()
        log({"phase": "fastsync_chain", **tag, "validators": n_vals, "heights": height_a,
             "upgrade_height": FASTSYNC_UPGRADE_HEIGHT, "txs": [len(b.data.txs) for b in blocks],
             "block_bytes": [len(b.to_bytes()) for b in blocks],
             "block_message_bytes": [len(json.dumps({"type": "block_response", "block": b.to_json()},
                                                    sort_keys=True)) for b in blocks],
             "parts": [b.make_part_set(part_size).total for b in blocks],
             "formats": [b.commit_format() for b in blocks[1:]], "build_s": time.perf_counter() - t0})
        del blocks
        server = serving_process(a.root, doc)
        nodes = []
        try:
            # B on the card: the main path, its launches and lanes counted
            verifier = Verifier(device=DEVICE)
            if verifier.kernel != "f32p" or verifier.device is None or verifier.device.type != dev_type:
                raise AssertionError(f"B's Verifier: kernel {verifier.kernel}, device {verifier.device}")
            hasher = Hasher(device=DEVICE)
            if hasher._route != "local":
                raise AssertionError(f"B's Hasher: route {hasher._route}")
            b = fastsync_node(doc, verifier, hasher, "B")
            nodes.append(b)
            v0, h0 = verifier.stats(), hasher.stats()
            gc.collect()
            reset_launches()
            run = b.sync(server)
            launches = read_launches()
            v1, h1 = verifier.stats(), hasher.stats()
            groups = [n for n in b.gate.sizes if n]
            widths, _ = b.rec.take()
            exp = fastsync_expected(doc, target, groups, widths, n_vals, len(synced_txs))
            lanes = {k: v1[k] - v0[k] for k in exp["lanes"]}
            bc = b.node.bc
            caught_up = {"is_caught_up": bc.pool.is_caught_up(), "pool_height": bc.pool.height,
                         "max_peer_height": bc.pool.max_peer_height, "store_height": b.store.height()}
            if b.store.height() != target or bc.blocks_synced != target or not caught_up["is_caught_up"] \
                    or bc.pool.height != height_a or bc.pool.max_peer_height != height_a:
                raise AssertionError(f"B synced {bc.blocks_synced} of A's {height_a} heights: {caught_up}")
            if b.node.consensus.switched != [want["state"]]:
                raise AssertionError(f"B switched to consensus {len(b.node.consensus.switched)} times, "
                                     "or with another state")
            if b.node.stops:
                raise AssertionError(f"B stopped peers: {b.node.stops}")
            proofs = n_vals * sum(not doc.aggregate_commits_at(h + 1) for h in range(1, target + 1))
            if any(n % n_vals or n > 4 * n_vals for n in groups) or sum(groups) != proofs:
                raise AssertionError(f"B's verify groups {groups}")
            _launch_delta(launches, exp["launches"], "B's sync")
            if lanes != exp["lanes"] or h1["cpu_leaves"] != h0["cpu_leaves"]:
                raise AssertionError(f"B's lanes {lanes}, expected {exp['lanes']}; "
                                     f"{h1['cpu_leaves'] - h0['cpu_leaves']} leaves on the host")
            got = fastsync_records(b.store, bc.state, target, sample)
            if got != want:
                raise AssertionError(f"B differs from A in {[k for k in got if got[k] != want[k]]}")
            (peer,) = b.node.sw.peers.list()
            log({"phase": "fastsync_path", **tag, "node": "B", "route": {"verify": verifier.kernel,
                 "hash": hasher._route}, "secretconn_backend": resolve_backend(),
                 "secret_connection": type(peer.stream).__name__, **caught_up,
                 "groups": groups, "commit_waves_k1": len(widths), "launches": launches,
                 "lanes": lanes, **run})
            b.close()
            nodes.remove(b)

            # B': the host reference
            ref_v = Verifier(min_tpu_batch=APP_REF_GATE, device="cpu")
            ref = fastsync_node(doc, ref_v, host_hasher(), "B-host")
            nodes.append(ref)
            gc.collect()
            reset_launches()
            ref_run = ref.sync(server)
            _launch_delta(read_launches(), {}, "B' (host reference)")
            got_ref = fastsync_records(ref.store, ref.node.bc.state, target, sample)
            if got_ref != want or ref.node.stops:
                raise AssertionError(f"B' differs from A in {[k for k in got_ref if got_ref[k] != want[k]]}, "
                                     f"stops {ref.node.stops}")
            log({"phase": "fastsync_path", **tag, "node": "B-host", "lanes": {
                k: ref_v.stats()[k] for k in exp["lanes"]}, **ref_run})
            ref.close()
            nodes.remove(ref)

            # C: a tampered peer dialed before A, on the card path
            tampered = FASTSYNC_TAMPER_HEIGHT + 1
            serve_c = serving_process(a.root, doc, tamper_height=tampered)
            nodes.append(serve_c)
            b2 = fastsync_node(doc, verifier, Hasher(device=DEVICE), "B2")
            nodes.append(b2)
            upto = tampered + 1
            tamper_run = b2.sync(serve_c, server, until_height=upto)
            if b2.node.stops != [(serve_c.node_id, "sent invalid block")]:
                raise AssertionError(f"the tampered peer: stops {b2.node.stops}")
            if [p.id() for p in b2.node.sw.peers.list()] != [server.node_id]:
                raise AssertionError("the tampered peer: A dropped")
            if fastsync_records(b2.store, None, upto, sample) != {
                    k: (v[:upto] if k != "commits" else v[:upto - 1]) for k, v in want.items()
                    if k in ("blocks", "metas", "commits", "seen")}:
                raise AssertionError("the tampered peer: the stored blocks differ from A's")
            log({"phase": "fastsync_tampered_peer", **tag, "tampered_height": tampered,
                 "stops": [(pid[:12], why) for pid, why in b2.node.stops], "synced_to": b2.store.height(),
                 "records": "equal to A's", "wall_s": tamper_run["wall_s"]})
        except BaseException:
            server.close()
            raise
        finally:
            for n in nodes:
                n.close()
    log({"phase": "fastsync_plane", **tag, "validators": n_vals, "heights": height_a, "synced": target,
         "launches": launches, "verifier": verifier.stats()})
    return {"doc": doc, "root": a.root, "server": server, "want": want, "sample": sample, "target": target,
            "runs": {"card": [run], "host": [ref_run]},
            "launches": {k: launches[k] for k in ("b1", "dsm", "ripemd160", "merkle_tree")}}


def fastsync_time(name, power, ctx) -> None:
    """Phase 30: B on the card and B' on the host reference in turns, each
    on fresh stores after a full collection (a fresh Hasher on the card
    each run, one Verifier), FASTSYNC_TIME_RUNS in all with phase 29's
    pair: the sync's wall time (the dial to the last block applied) and
    blocks/s, the reactor's stage_s split, and the wall time the stages do
    not account for (the transport and the pool). Every run ends at A's
    height less one with A's state there (phase 29 held every record)."""
    from tendermint_tpu_torch.ops.gateway import Hasher, Verifier

    tag = {"card": name, "power_limit": power}
    doc, server, want, sample, target = ctx["doc"], ctx["server"], ctx["want"], ctx["sample"], ctx["target"]
    runs = ctx["runs"]
    verifier = Verifier(device=DEVICE)
    ref_v = Verifier(min_tpu_batch=APP_REF_GATE, device="cpu")
    with routed_to():
        for _ in range(FASTSYNC_TIME_RUNS - 1):
            for label in ("card", "host"):
                v, h = (verifier, Hasher(device=DEVICE)) if label == "card" else (ref_v, host_hasher())
                node = fastsync_node(doc, v, h, f"B-{label}")
                try:
                    gc.collect()
                    run = node.sync(server)
                    if node.store.height() != target or node.node.bc.state.bytes_() != want["state"]:
                        raise AssertionError(f"{label} run: the store height or the state differs from A's")
                finally:
                    node.close()
                runs[label].append(run)
    best = {label: min(rows, key=lambda r: r["wall_s"]) for label, rows in runs.items()}
    log({"phase": "fastsync_time", **tag, "runs": FASTSYNC_TIME_RUNS, "blocks": target,
         "fastsync_blocks_per_sec": best["card"]["blocks_per_s"],
         "host_blocks_per_sec": best["host"]["blocks_per_s"],
         "speedup": best["host"]["wall_s"] / best["card"]["wall_s"],
         "card_best": best["card"], "host_best": best["host"],
         "card_runs": runs["card"], "host_runs": runs["host"]})



# -- phases 31 and 32: the consensus state machine -----------------------------


def committee_pkg(root: str = "tendermint_tpu_torch"):
    """The classes a committee node is wired from, taken from the package
    `root` by name (the port's; its tests wire the JAX package's the same
    way to hold the two against each other)."""
    import importlib
    import types

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    signedkv = mod("abci.apps.signedkv")
    mempool = mod("mempool.mempool")
    vote = mod("types.vote")
    return types.SimpleNamespace(
        root=root,
        ConsensusState=mod("consensus.state").ConsensusState,
        msgs=mod("consensus.messages"),
        RoundStep=mod("consensus.round_state").RoundStep,
        Handshaker=mod("consensus.replay").Handshaker,
        SignedKVStoreApp=signedkv.SignedKVStoreApp,
        parse_sig_tx=signedkv.parse_sig_tx,
        make_sig_tx=signedkv.make_sig_tx,
        gen_priv_key_ed25519=mod("crypto.keys").gen_priv_key_ed25519,
        BlockStore=mod("blockchain.store").BlockStore,
        test_config=mod("config").test_config,
        db_provider=mod("libs.db").db_provider,
        MemDB=mod("libs.db").MemDB,
        EventSwitch=mod("libs.events").EventSwitch,
        Mempool=mempool.Mempool,
        SigBatcher=mempool.SigBatcher,
        AppConns=mod("proxy").AppConns,
        LocalClientCreator=mod("proxy").LocalClientCreator,
        State=mod("state.state").State,
        Block=mod("types.block").Block,
        empty_commit=mod("types.block").empty_commit,
        BlockID=mod("types.block_id").BlockID,
        Proposal=mod("types.proposal").Proposal,
        Vote=vote.Vote,
        VOTE_TYPE_PREVOTE=vote.VOTE_TYPE_PREVOTE,
        VOTE_TYPE_PRECOMMIT=vote.VOTE_TYPE_PRECOMMIT,
        PrivValidatorFS=mod("types.priv_validator").PrivValidatorFS,
        SignatureEd25519=mod("crypto.keys").SignatureEd25519,
        GenesisDoc=mod("types.genesis").GenesisDoc,
        GenesisValidator=mod("types.genesis").GenesisValidator,
    )


def committee_genesis(p, keys, own_addr: bytes, own_power: int, upgrade_height: int,
                      chain_id: str = CHAIN_ID):
    """The committee's genesis: `keys` (PrivKeyEd25519) at power 1, but the
    node's key (`own_addr`) at `own_power`, default ConsensusParams, and the
    upgrade to aggregate commits at `upgrade_height` (docs/upgrade.md)."""
    return p.GenesisDoc(
        genesis_time_ns=BLOCK_TIME_NS, chain_id=chain_id,
        validators=[p.GenesisValidator(k.pub_key(), own_power if k.pub_key().address() == own_addr else 1)
                    for k in keys],
        upgrade_height=upgrade_height, upgrade_format="aggregate",
    )


def committee_schedule(p, doc, heights: int) -> dict[int, bytes]:
    """The proposer's address at heights 1..`heights` of round 0: the
    genesis set's rotation, advanced once a height as State advances it."""
    vals = p.State.get_state(p.MemDB(), doc).validators
    out = {}
    for h in range(1, heights + 1):
        out[h] = vals.get_proposer().address
        vals = vals.copy()
        vals.increment_accum(1)
    return out


def committee_power(p, keys, heights: int, upgrade_height: int, idle: tuple[int, ...]) -> tuple[bytes, int, list]:
    """(the node's address, its power, the heights it proposes). The node
    runs the height-1 proposer's key of the equal-power set (as
    benches/bench_committee.py picks it); its power is the largest of at
    most a fifth of the total (so a quorum needs the stubs) with which the
    rotation elects it at height 1, at one height in [upgrade_height,
    heights] and at none of `idle` (the heights after a restart, so the
    restart finds no proposal of its own in flight)."""
    flat = committee_genesis(p, keys, b"", 1, upgrade_height)
    own = committee_schedule(p, flat, 1)[1]
    last = max((heights,) + idle)
    for power in range((len(keys) - 1) // 4, 0, -1):
        sched = committee_schedule(p, committee_genesis(p, keys, own, power, upgrade_height), last)
        mine = [h for h, addr in sched.items() if addr == own]
        if mine[0] == 1 and any(upgrade_height <= h <= heights for h in mine) and not set(mine) & set(idle):
            return own, power, mine
    raise AssertionError("no power of at most a fifth of the total gives the committee's schedule")


class vote_rejects:
    """The consensus state's flight-recorder seam (duck-typed, as
    node/flightrec.py is): keeps every refused vote's record, every
    exception the receive routine noted and every height adopted from an
    aggregate commit proof."""

    def __init__(self):
        self.rejects: list[dict] = []
        self.exceptions: list[str] = []
        self.proofs: list[int] = []  # heights finalized from an aggregate commit proof

    def record(self, kind: str, **fields) -> None:
        if kind == "vote_reject":
            self.rejects.append(fields)
        elif kind == "agg_commit_proof":
            self.proofs.append(fields["height"])

    def note_exception(self, source: str, exc: BaseException) -> None:
        self.exceptions.append(f"{source}: {type(exc).__name__}: {exc}")

    def note_vote_dup(self, peer_id: str) -> None:
        pass


class verify_log:
    """The node's Verifier with every dispatch recorded as (source, lanes):
    "one" for a lone signature on the host (verify_one: a vote the
    VoteBatcher left single, a proposal's signature), "vote" for a
    VoteBatcher micro-batch (prime_cache_async), "aggregate"
    for an aggregate LastCommit's n + 1 lanes (or the tag of
    `tagged_aggregate(...)` around it), the tag of `tagged(...)` around a
    call, else "commit" (validate_block's LastCommit verify). The
    Verifier is wrapped in place: the consensus state, the gate and the app
    keep calling it as they would."""

    def __init__(self, verifier):
        self.verifier = verifier
        self.calls: list[tuple[str, int]] = []
        self.agg_sites: dict[tuple, int] = {}
        self._local = threading.local()
        self._mtx = threading.Lock()
        batch_async, prime_async, aggregate, one = (verifier.verify_batch_async, verifier.prime_cache_async,
                                                    verifier.verify_aggregate, verifier.verify_one)

        def logged_batch_async(items):
            self._note(getattr(self._local, "source", None) or "commit", len(items))
            return batch_async(items)

        def logged_prime_async(items, on_done=None):
            with self.tagged("vote"):
                return prime_async(items, on_done)

        def logged_aggregate(pubs, msgs, rs, s_agg):
            source = getattr(self._local, "agg_source", None) or "aggregate"
            self._note(source, len(pubs) + 1)
            # where each aggregate check comes from: its height (in the
            # signed message), its thread and its callers
            m = re.search(rb'"height":(\d+)', msgs[0]) if msgs else None
            site = (source, int(m.group(1)) if m else None, threading.current_thread().name.split(":")[0],
                    "<".join(f.name for f in traceback.extract_stack(limit=7)[-7:-1][::-1]))
            with self._mtx:
                self.agg_sites[site] = self.agg_sites.get(site, 0) + 1
            return aggregate(pubs, msgs, rs, s_agg)

        def logged_one(pubkey, msg, sig):
            self._note("one", 1)
            return one(pubkey, msg, sig)

        verifier.verify_batch_async = logged_batch_async
        verifier.prime_cache_async = logged_prime_async
        verifier.verify_aggregate = logged_aggregate
        verifier.verify_one = logged_one

    def _note(self, source: str, lanes: int) -> None:
        with self._mtx:
            self.calls.append((source, lanes))

    @contextlib.contextmanager
    def tagged(self, tag: str):
        """Tag this thread's dispatches inside the block."""
        saved = getattr(self._local, "source", None)
        self._local.source = tag
        try:
            yield
        finally:
            self._local.source = saved

    @contextlib.contextmanager
    def tagged_aggregate(self, tag: str):
        """Tag this thread's aggregate verifies inside the block (they are
        "aggregate" otherwise)."""
        saved = getattr(self._local, "agg_source", None)
        self._local.agg_source = tag
        try:
            yield
        finally:
            self._local.agg_source = saved

    def view(self, tag: str):
        """The verifier as a caller tagged `tag` sees it (the gate's
        verify_batch_async, the app's verify_batch)."""
        log = self

        class view:
            def verify_batch_async(self, items):
                with log.tagged(tag):
                    return log.verifier.verify_batch_async(items)

            def verify_batch(self, items):
                with log.tagged(tag):
                    return log.verifier.verify_batch(items)

        return view()

    def take(self) -> list[tuple[str, int]]:
        with self._mtx:
            out, self.calls = self.calls, []
        return out


class committee_node:
    """The node of the consensus_committee cell, wired as node/node.py wires
    one, in `root` (made at genesis by committee_home): sqlite `state` and
    `blockstore` DBs; a SignedKVStoreApp (its CheckTx left to the gate,
    its block verify through `verifier`, its tree hashing through `hasher`,
    APP_SHARDS shards) behind AppConns(LocalClientCreator) with the
    Handshaker, which replays the stored blocks into the fresh app; a
    Mempool with its WAL, gated by SigBatcher(verifier, parse_sig_tx); and a
    ConsensusState over them with its WAL on disk, `pipeline_apply` on, the
    file privval, `verifier=verifier` and `hasher` as its part hasher;
    with `tx_index` a KVTxIndexer on a `tx_index` DB, as node/node.py
    wires one. The
    liveness timeouts are generous (the pump is prompt, and a stray round
    would fork the comparison) and block times pinned, as
    benches/bench_committee.py builds its node. `log` (a verify_log around
    `verifier`) tags the gate's and the app's dispatches."""

    def __init__(self, p, root: str, doc, verifier, hasher=None, log=None, tx_index: bool = False):
        self.p, self.root, self.doc = p, root, doc
        names = ("state", "blockstore") + (("tx_index",) if tx_index else ())
        self.dbs = {n: p.db_provider(n, "sqlite", root) for n in names}
        self.store = p.BlockStore(self.dbs["blockstore"])
        state = p.State.get_state(self.dbs["state"], doc)
        if tx_index:
            from tendermint_tpu_torch.state.txindex import KVTxIndexer

            state.tx_indexer = KVTxIndexer(self.dbs["tx_index"])
        self.app = p.SignedKVStoreApp(verify_in_app=False)
        self.app.deliver_verifier = log.view("deliver") if log is not None else verifier
        self.rec = None
        if hasher is not None:
            self.rec = wave_recorder(hasher)
            self.app.tree.hasher = self.rec
        self.app.shards = APP_SHARDS
        self.handshaker = p.Handshaker(state, self.store)
        self.conns = p.AppConns(p.LocalClientCreator(self.app), self.handshaker)
        self.conns.start()
        cfg = p.test_config()
        cfg.set_root(root)
        cc = cfg.consensus
        cc.timeout_commit = 0.05
        cc.skip_timeout_commit = True
        cc.timeout_propose = cc.timeout_prevote = cc.timeout_precommit = 60.0
        self.gate = batch_recorder(log.view("gate") if log is not None else verifier)
        self.batcher = p.SigBatcher(self.gate, p.parse_sig_tx)
        self.mempool = p.Mempool(cfg.mempool, self.conns.mempool(), sig_batcher=self.batcher)
        self.mempool.init_wal()
        self.pv = p.PrivValidatorFS.load(os.path.join(root, "priv_validator.json"))
        # a restart's reconstruct_last_commit primes the seen commit here
        with log.tagged("seen_commit") if log is not None else contextlib.nullcontext():
            self.cs = p.ConsensusState(cc, state.copy(), self.conns.consensus(), self.store, self.mempool,
                                       verifier=verifier)
        if hasher is not None:
            self.cs.part_hasher = hasher
        self.cs.set_priv_validator(self.pv)
        self.evsw = p.EventSwitch()
        self.evsw.start()
        self.cs.set_event_switch(self.evsw)
        self.cs.propose_time_source = lambda h: BLOCK_TIME_NS + h * 10**9
        self.flight = vote_rejects()
        self.cs.flightrec = self.flight
        self.started = False

    def feed(self, txs: list[bytes], timeout: float = EXEC_DRAIN_S) -> list[int]:
        """check_tx every tx and wait for every answer, then until the pool
        holds the accepted ones beside those it held; returns the refused
        positions."""
        codes: dict[int, int] = {}
        before = self.mempool.size()
        for i, tx in enumerate(txs):
            self.mempool.check_tx(tx, cb=lambda res, i=i: codes.__setitem__(i, res.code))
        deadline = time.monotonic() + timeout
        refused: list[int] = []
        while True:
            if len(codes) == len(txs):
                refused = sorted(i for i, c in codes.items() if c)
                if self.mempool.size() >= before + len(txs) - len(refused):
                    return refused
            if time.monotonic() > deadline:
                raise AssertionError(f"feed: {len(codes)} of {len(txs)} answered, {self.mempool.size()} pooled")
            time.sleep(0.0005)

    def state_bytes(self) -> bytes:
        return self.p.State.load_state(self.dbs["state"], self.doc).bytes_()

    def records(self, first: int, last: int) -> list[dict]:
        """What the node stored for heights first..last: the block's bytes,
        hash, part-set root, header app hash and seen commit."""
        out = []
        for h in range(first, last + 1):
            meta, block = self.store.load_block_meta(h), self.store.load_block(h)
            out.append({"height": h, "hash": meta.block_id.hash.hex(),
                        "parts": meta.block_id.parts_header.hash.hex(),
                        "parts_total": meta.block_id.parts_header.total,
                        "app_hash": block.header.app_hash.hex(), "block": block.to_bytes(),
                        "seen": self.store.load_seen_commit(h).to_json(),
                        "format": block.commit_format()})
        return out

    def stop(self) -> bytes:
        """Stop consensus (the deferred apply drained), the gate, the WALs
        and the app; returns the saved state's bytes, then closes the DBs."""
        if self.started:
            self.cs.stop()
        self.batcher.stop()
        self.mempool.close_wal()
        self.conns.stop()
        self.evsw.stop()
        try:
            return self.state_bytes()
        finally:
            for db in self.dbs.values():
                db.close()


def committee_home(p, root: str, own_key) -> None:
    """A node home: the directory and the node's file privval."""
    os.makedirs(root, exist_ok=True)
    p.PrivValidatorFS(own_key, os.path.join(root, "priv_validator.json")).save()


def _committee_wait(cond, seconds: float, what: str, node) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        err = getattr(node.cs, "device_error", None)
        if err is not None:
            raise AssertionError(f"consensus stopped on a device error: {err}")
        if time.monotonic() > deadline:
            rs = node.cs.rs
            raise AssertionError(f"committee pump: waited {seconds} s for {what} "
                                 f"(at {rs.height}/{rs.round_}/{int(rs.step)})")
        time.sleep(0.0005)


def committee_pump(node, keys, bursts, first: int, last: int, forged_height: int | None = None,
                   restarted: bool = False, wait_s: float = 120.0, on_height=None) -> dict:
    """Start `node` and drive heights first..last as benches/bench_committee.py
    drives its node, with txs: bursts[h - 1] (a dict of "txs") is fed
    through check_tx before height h's proposal (before start for `first`,
    else between height h-1's prevotes and precommits), and every other
    key of `keys` is a stub. When the rotation elects a stub, the pump
    builds the block the node would build (the reaped txs, the pinned time,
    the LastCommit through the node's own `_commit_for_proposal`), signs
    the proposal and sends it with its parts; then it injects every stub's
    prevote and, once the node precommits, every stub's precommit. At
    `forged_height` the first stub's precommit carries a flipped signature.
    Each height starts once the node holds the applied state of the one
    before and its LastCommit holds every precommit sent (on a `restarted`
    node the first height's LastCommit is the stored seen commit). Returns
    the refusals of each burst, the proposers, the applied state's bytes
    at the start of each height and after the last, the pump's signing
    seconds and the wall time."""
    p, cs = node.p, node.cs
    chain_id = node.doc.chain_id
    own = node.pv.get_address()
    stubs = [(i, p.PrivValidatorFS(k, None)) for i, k in enumerate(keys) if k.pub_key().address() != own]
    part_size = node.doc.consensus_params.block_gossip.block_part_size_bytes
    out = {"refused": {}, "proposers": {}, "states": {}, "sign_s": 0.0, "forged": None}
    out["refused"][first] = node.feed(bursts[first - 1]["txs"])

    def applied(h: int) -> bool:
        # at height h over the applied state of h - 1: finalize sets the
        # deferred apply before it moves to h, and the join clears it, then
        # swaps the state in and clears the provisional flag, so these
        # reads in this order never pass in between
        return (cs.rs.height == h and cs._pending_apply is None and not cs._state_provisional
                and cs.state.last_block_height == h - 1)

    t0 = time.perf_counter()
    cs.start()
    node.started = True
    for h in range(first, last + 1):
        want = len(keys) - (h - 1 == forged_height)

        def ready():
            if not applied(h):
                return False
            if h == 1 or (restarted and h == first):
                return True
            lc = cs.rs.last_commit
            return lc is not None and lc.bit_array().num_true_bits() == want

        _committee_wait(ready, wait_s, f"height {h}", node)
        if on_height is not None:
            on_height(h)
        out["states"][h - 1] = cs.state.bytes_()  # the applied state of h - 1
        proposer = cs.rs.validators.get_proposer().address
        out["proposers"][h] = proposer
        if proposer != own:
            commit = p.empty_commit() if h == 1 else cs._commit_for_proposal(cs.rs.last_commit.make_commit())
            txs = cs.mempool.reap(cs.config.max_block_size_txs)
            block, parts = p.Block.make_block(
                height=h, chain_id=chain_id, txs=txs, commit=commit, prev_block_id=cs.state.last_block_id,
                val_hash=cs.state.validators.hash(), app_hash=cs.state.app_hash, part_size=part_size,
                time_ns=BLOCK_TIME_NS + h * 10**9)
            pv = next(pv for _, pv in stubs if pv.get_address() == proposer)
            cs.set_proposal_msg(pv.sign_proposal(chain_id, p.Proposal(h, 0, parts.header())), peer_id="pump")
            for i in range(parts.total):
                cs.add_peer_message(p.msgs.BlockPartMessage(h, 0, parts.get_part(i)), "pump")
        _committee_wait(lambda: cs.rs.height > h or (cs.rs.height == h and cs.rs.proposal_block is not None
                                                     and cs.rs.proposal_block_parts.is_complete()),
                        wait_s, f"the proposal at {h}", node)
        bid = p.BlockID(cs.rs.proposal_block.hash(), cs.rs.proposal_block_parts.header())
        for type_ in (p.VOTE_TYPE_PREVOTE, p.VOTE_TYPE_PRECOMMIT):
            t1 = time.perf_counter()
            votes = [pv.sign_vote(chain_id, p.Vote(pv.get_address(), i, h, 0, type_, bid)) for i, pv in stubs]
            if type_ == p.VOTE_TYPE_PRECOMMIT and h == forged_height:
                raw = bytearray(votes[0].signature.raw)
                raw[5] ^= 0x20
                votes[0] = votes[0].with_signature(p.SignatureEd25519(bytes(raw)))
                out["forged"] = (h, votes[0].validator_index)
            out["sign_s"] += time.perf_counter() - t1
            for v in votes:
                cs.add_vote_msg(v, peer_id="pump")
            if type_ == p.VOTE_TYPE_PREVOTE:
                # the node locks and its precommit is in before the precommit
                # wave: every height commits at round 0, and the seen commit
                # holds the same precommits in every run
                own_idx, _ = cs.rs.validators.get_by_address(own)
                _committee_wait(lambda: cs.rs.height > h or (
                    cs.rs.step >= p.RoundStep.PRECOMMIT
                    and cs.rs.votes.precommits(0).get_by_index(own_idx) is not None),
                    wait_s, f"the node's precommit at {h}", node)
                if h < last:
                    out["refused"][h + 1] = node.feed(bursts[h]["txs"])
    _committee_wait(lambda: applied(last + 1) and node.store.height() == last, wait_s, "the last commit", node)
    out["wall_s"] = time.perf_counter() - t0
    out["states"][last] = cs.state.bytes_()
    return out



def make_committee_inputs(pool, rng) -> list[dict]:
    """Phase 31's bursts, from their own generator so the earlier phases'
    draws stay as they were: one a height (the restart's two included),
    the first of COMMITTEE_FIRST_BLOCK and the rest of COMMITTEE_BLOCK."""
    return make_bursts(pool, rng, COMMITTEE_HEIGHTS + COMMITTEE_RESTART_HEIGHTS, COMMITTEE_FIRST_BLOCK,
                       COMMITTEE_BLOCK, COMMITTEE_VALUE_BYTES, EXEC_SIGNERS, b"cmt-%07d")


def _hist_reading() -> dict[str, tuple[int, float]]:
    """(count, sum) of the vote plane's and the pipeline's histograms."""
    from tendermint_tpu_torch.consensus import pipeline as cpipeline
    from tendermint_tpu_torch.consensus import vote_batcher as cvb

    hists = {"vote_batch": cvb.vote_batch_hists()["batch"], **cpipeline.pipeline_hists()}
    return {k: (h.count, h.sum) for k, h in hists.items() if k in ("vote_batch", "join_wait", "overlap")}


class committee_setup:
    """The consensus_committee cell's chain: phase 3's first
    COMMITTEE_VALIDATORS keys, the node's power (committee_power), the
    genesis and the bursts."""

    def __init__(self, seeds, bursts):
        self.p = committee_pkg()
        keys = [self.p.gen_priv_key_ed25519(s) for s in seeds[:COMMITTEE_VALIDATORS]]
        keys.sort(key=lambda k: k.pub_key().address())
        self.keys = keys
        last = COMMITTEE_HEIGHTS + COMMITTEE_RESTART_HEIGHTS
        self.own, self.own_power, self.own_heights = committee_power(
            self.p, keys, COMMITTEE_HEIGHTS, COMMITTEE_UPGRADE_HEIGHT,
            idle=tuple(range(COMMITTEE_HEIGHTS + 1, last + 1)))
        self.own_key = next(k for k in keys if k.pub_key().address() == self.own)
        self.doc = committee_genesis(self.p, keys, self.own, self.own_power, COMMITTEE_UPGRADE_HEIGHT)
        self.bursts = bursts
        self.last = last

    def run(self, verifier, hasher, root: str, first: int, last: int, log=None, restarted: bool = False) -> dict:
        """One session of the node in `root`: built (a restart when the
        home holds a chain), pumped through heights first..last, stopped.
        Returns the pump's result, the launches, the node's records, the
        saved state, the Verifier's and Hasher's stat deltas, the vote
        plane's and the pipeline's readings and the traces."""
        from tendermint_tpu_torch.ops import gateway
        from tendermint_tpu_torch.types import tx as ptx

        gateway._default_verifier, gateway._default_hasher = verifier, hasher
        ptx.set_batch_tx_root(hasher.tx_merkle_root)
        v0, h0, hist0 = verifier.stats(), hasher.stats(), _hist_reading()
        gc.collect()
        reset_launches()
        t0 = time.perf_counter()
        node = committee_node(self.p, root, self.doc, verifier, hasher, log)
        build_s = time.perf_counter() - t0
        try:
            out = committee_pump(node, self.keys, self.bursts, first, last,
                                 forged_height=COMMITTEE_FORGED_HEIGHT, restarted=restarted,
                                 wait_s=COMMITTEE_WAIT_S)
            if verifier.device is not None and verifier.device.type == "cuda":
                _sync()
            launches = read_launches()
            records = node.records(1, last)
            round_zero = all(all(v is None or v.round_ == 0 for v in node.store.load_seen_commit(h).precommits)
                             for h in range(first, last + 1))
        finally:
            ptx.set_batch_tx_root(None)
            state = node.stop()
        cs = node.cs
        v1, h1, hist1 = verifier.stats(), hasher.stats(), _hist_reading()
        if cs.device_error is not None or node.flight.exceptions:
            raise AssertionError(f"consensus stopped: {cs.device_error} {node.flight.exceptions}")
        widths, _ = node.rec.take()
        return {
            "out": out, "launches": launches, "records": records, "state": state, "build_s": build_s,
            "verifier": {k: v1[k] - v0[k] for k in ("tpu_batches", "tpu_sigs", "cpu_sigs", "agg_batches",
                                                   "agg_lanes_device", "agg_lanes_cpu")},
            "hasher": {k: h1[k] - h0[k] for k in ("tpu_part_batches", "tpu_tx_roots", "tpu_leaves", "cpu_leaves")},
            "waves": widths, "gate_sizes": node.gate.take()[0],
            "rejects": [(r["height"], r["type"], r["err"].split(":")[0]) for r in node.flight.rejects],
            "vote_plane": {"batches": cs.vote_batcher.batches, "batched_sigs": cs.vote_batcher.batched_sigs,
                           "singletons": cs.vote_batcher.singletons,
                           "vote_verify_batch_count": hist1["vote_batch"][0] - hist0["vote_batch"][0],
                           "consensus_vote_verify_batch_seconds": hist1["vote_batch"][1] - hist0["vote_batch"][1]},
            "pipeline": {"join_wait_s": hist1["join_wait"][1] - hist0["join_wait"][1],
                         "joins": hist1["join_wait"][0] - hist0["join_wait"][0],
                         "overlap_s": hist1["overlap"][1] - hist0["overlap"][1]},
            "traces": [t.to_json() for t in cs.trace.last(last - first + 1)],
            "round_zero": round_zero,
        }


def committee_expected(run: dict, setup, first: int, last: int, gate: int, hash_gate: int,
                       restarted: bool) -> dict:
    """The launches the chain implies for one session, from the code's
    call sites (consensus/state.py, state/execution.py, types/tx.py):

    - B1: one launch a dispatch of `gate` lanes or more, and the session
      has one a vote micro-batch that wide (VoteBatcher.prepare), four a
      height with a full LastCommit (validate_block's verify_commit at the
      prevote, at the lock, at finalize and in apply_block), one a deliver
      (the signed kvstore's block verify: each height applied, and on a
      restart each block the Handshaker replays), one a gate batch that
      wide, and on a restart one for the seen commit
      (reconstruct_last_commit's prime);
    - dsm: four a height with an aggregate LastCommit, n + 1 lanes each;
    - K1 and K3: one each a tx root (a height's tx set: the node's own
      proposal submits it, a stub's block is built through the same hook,
      and every later check joins the Hasher's cache) and a part set of
      the node's own proposals at or above `hash_gate` parts; K1 once more
      a state-tree wave at or above `hash_gate` leaves."""
    doc = setup.doc
    calls = run["calls"]
    device = [(src, n) for src, n in calls if n >= gate]
    by_source: dict[str, int] = {}
    for src, _ in device:
        by_source[src] = by_source.get(src, 0) + 1
    heights = range(first, last + 1)
    full = sum(h >= 2 and not doc.aggregate_commits_at(h) for h in heights)
    agg = sum(doc.aggregate_commits_at(h) for h in heights)
    replayed = first - 1 if restarted else 0
    want_sources = {"commit": 4 * full, "deliver": len(heights) + replayed, "aggregate": 4 * agg,
                    "seen_commit": 1 if restarted else 0,
                    "vote": sum(1 for src, n in calls if src == "vote" and n >= gate),
                    "gate": sum(1 for n in run["gate_sizes"] if n >= gate)}
    got_sources = {k: by_source.get(k, 0) for k in want_sources}
    if got_sources != want_sources or set(by_source) - set(want_sources):
        raise AssertionError(f"dispatches by source {by_source}, expected {want_sources}")
    parts = {r["height"]: r["parts_total"] for r in run["records"]}
    own = sum(h in setup.own_heights and parts[h] >= hash_gate for h in heights)
    own_host_parts = sum(parts[h] for h in heights if h in setup.own_heights and parts[h] < hash_gate)
    waves = sum(w >= hash_gate for w in run["waves"])
    b1 = sum(v for k, v in want_sources.items() if k != "aggregate")
    return {"b1": b1, "dsm": want_sources["aggregate"], "ripemd160": len(heights) + own + waves,
            "merkle_tree": len(heights) + own, "sources": want_sources, "own_proposals": own,
            "own_host_parts": own_host_parts,
            "waves_device": waves}


def committee_check(label: str, run: dict, want_records, want_state, setup, first: int, last: int,
                    verifier, hasher, restarted: bool) -> dict:
    """Phase 31's checks of one card session against the host reference's
    records and state, and its launches against committee_expected."""
    from tendermint_tpu_torch.types import block as pblock

    gate, hash_gate = verifier.min_tpu_batch, hasher.min_tpu_batch
    exp = committee_expected(run, setup, first, last, gate, hash_gate, restarted)
    if run["records"] != want_records:
        diff = [r["height"] for r, w in zip(run["records"], want_records) if r != w]
        raise AssertionError(f"{label}: heights {diff} differ from the host reference")
    if run["state"] != want_state:
        raise AssertionError(f"{label}: the final state differs from the host reference")
    if not run["round_zero"]:
        raise AssertionError(f"{label}: a height committed after round 0")
    _launch_delta(run["launches"], {k: exp[k] for k in ("b1", "dsm", "ripemd160", "merkle_tree")}, label)
    device = [(src, n) for src, n in run["calls"] if n >= gate]
    lanes = {"tpu_sigs": sum(n for src, n in device if src != "aggregate"),
             "agg_lanes_device": sum(n for src, n in device if src == "aggregate")}
    if any(run["verifier"][k] != v for k, v in lanes.items()) or run["verifier"]["agg_lanes_cpu"]:
        raise AssertionError(f"{label}: verifier lanes {run['verifier']}, expected {lanes}")
    h = run["hasher"]
    # part batches: the node's own part sets and the state tree's waves
    parts = exp["own_proposals"] + exp["waves_device"]
    if h["tpu_tx_roots"] != last - first + 1 or h["tpu_part_batches"] != parts \
            or h["cpu_leaves"] != exp["own_host_parts"]:
        raise AssertionError(f"{label}: hasher {h}, expected {last - first + 1} tx roots, {parts} part "
                             f"batches and {exp['own_host_parts']} leaves on the host")
    for r in run["records"][first - 1:]:
        if len(pblock.Block.from_bytes(r["block"]).data.txs) != len(setup.bursts[r["height"] - 1]["txs"]) - len(
                setup.bursts[r["height"] - 1]["forged"]):
            raise AssertionError(f"{label}: height {r['height']} did not commit its burst")
    return exp


def committee_reference(seeds, bursts, knobs: dict) -> list[dict]:
    """Phase 31's host reference, in a process of its own: the node on a
    Verifier whose gate sends every lane to the native CPU floor (the
    aggregate LastCommits on the host's reference check) and
    host_hasher(), its two sessions (heights 1..COMMITTEE_HEIGHTS, then a
    restart from its files and the rest), neither launching a kernel.
    `knobs` are the parent's COMMITTEE_* values (a spawned process
    imports this module afresh)."""
    from tendermint_tpu_torch.ops.gateway import Verifier

    globals().update(knobs)
    setup = committee_setup(seeds, bursts)
    root = tempfile.mkdtemp(prefix="committee-host-")
    try:
        with routed_to():
            ref_v = Verifier(min_tpu_batch=APP_REF_GATE, device="cpu")
            ref_h = host_hasher()
            committee_home(setup.p, root, setup.own_key)
            ref = [setup.run(ref_v, ref_h, root, 1, COMMITTEE_HEIGHTS),
                   setup.run(ref_v, ref_h, root, COMMITTEE_HEIGHTS + 1, setup.last, restarted=True)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for i, r in enumerate(ref):
        _launch_delta(r["launches"], {}, f"host reference session {i + 1}")
    return ref


def committee_phase(name, power, seeds, bursts) -> dict:
    """Phase 31: the consensus state machine on the card, in process (no
    daemon socket). The consensus_committee cell's node (committee_node on
    Verifier(device=DEVICE) and Hasher(device=DEVICE), installed as the
    gateway's defaults, the tx-root hook on the Hasher) commits heights
    1..COMMITTEE_HEIGHTS under committee_pump, one stub's precommit at
    COMMITTEE_FORGED_HEIGHT forged; then a new node over the same files
    (the Handshaker replaying the stored blocks into a fresh app, the WAL
    catchup, the seen commit primed) commits COMMITTEE_RESTART_HEIGHTS
    more. The host reference (committee_reference) runs the same two
    sessions in a process of its own, beside the card node's (its
    pure-Python aggregate checks take most of the phase), and launches
    nothing. Every height commits at round 0; records, state,
    the gate's refusals (the forged txs alone), the proposers and the
    refused votes (the forged precommit alone) are equal; each session's
    launches are reset just before the node is built and read just after
    the pump, and must be committee_expected's; tpu_sigs and
    agg_lanes_device equal the device lanes dispatched. Returns what phase
    32 needs and the launches."""
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops.gateway import Hasher, Verifier

    tag = {"card": name, "power_limit": power}
    setup = committee_setup(seeds, bursts)
    p, n = setup.p, len(setup.keys)
    total = setup.own_power + n - 1
    log({"phase": "committee_setup", **tag, "validators": n, "node_power": setup.own_power,
         "total_power": total, "node_share": setup.own_power / total,
         "node_proposes_at": setup.own_heights, "upgrade_height": COMMITTEE_UPGRADE_HEIGHT,
         "heights": COMMITTEE_HEIGHTS, "restart_heights": COMMITTEE_RESTART_HEIGHTS,
         "txs_per_height": [len(b["txs"]) for b in bursts], "forged_precommit_height": COMMITTEE_FORGED_HEIGHT})
    if setup.own_power * 5 > total:
        raise AssertionError("the node's power is over a fifth of the total")
    first_end, last = COMMITTEE_HEIGHTS, setup.last
    sessions = ((1, first_end, False), (first_end + 1, last, True))  # (first, last, restarted)
    saved = gateway._default_verifier, gateway._default_hasher
    roots = []
    reference = multiprocessing.get_context("spawn").Pool(1)
    try:
        knobs = {k: v for k, v in globals().items() if k.startswith("COMMITTEE_")}
        pending = reference.apply_async(committee_reference, (seeds[:COMMITTEE_VALIDATORS], bursts, knobs))
        with routed_to():
            verifier = Verifier(device=DEVICE)
            hasher = Hasher(device=DEVICE)
            if verifier.kernel != "f32p" or hasher._route != "local":
                raise AssertionError(f"the card node's routes: {verifier.kernel}, {hasher._route}")
            vlog = verify_log(verifier)
            root = tempfile.mkdtemp(prefix="committee-card-")
            roots.append(root)
            committee_home(p, root, setup.own_key)
            card = []
            for a, b, restarted in sessions:
                run = setup.run(verifier, hasher, root, a, b, log=vlog, restarted=restarted)
                run["calls"] = vlog.take()
                card.append(run)
            ref = pending.get(timeout=COMMITTEE_REFERENCE_S)
            for i, r in enumerate(ref):
                log({"phase": "committee_path", **tag, "node": "host", "session": i + 1,
                     "wall_s": r["out"]["wall_s"], "build_s": r["build_s"], "verifier": r["verifier"]})
            for i, ((a, b, restarted), run) in enumerate(zip(sessions, card)):
                want = ref[i]
                for key in ("refused", "proposers", "states", "forged"):
                    if run["out"][key] != want["out"][key]:
                        raise AssertionError(f"card session {i + 1}: {key} {run['out'][key]} != {want['out'][key]}")
                if run["rejects"] != want["rejects"]:
                    raise AssertionError(f"card session {i + 1}: refused votes {run['rejects']}")
                exp = committee_check(f"card session {i + 1}", run, want["records"], want["state"], setup,
                                      a, b, verifier, hasher, restarted)
                log({"phase": "committee_path", **tag, "node": "card", "session": i + 1, "heights": [a, b],
                     "restarted": restarted, "launches": run["launches"], "sources": exp["sources"],
                     "verifier": run["verifier"], "hasher": run["hasher"], "vote_plane": run["vote_plane"],
                     "gate_batches": len(run["gate_sizes"]), "waves_device": exp["waves_device"],
                     "wall_s": run["out"]["wall_s"], "build_s": run["build_s"], "records": "equal to the host's"})
            refused = card[0]["rejects"] + card[1]["rejects"]
            if refused != [(COMMITTEE_FORGED_HEIGHT, 2, "InvalidSignatureError")]:
                raise AssertionError(f"refused votes {refused}: expected the forged precommit alone")
            if any(r["out"]["refused"][h] != bursts[h - 1]["forged"] for r in card for h in r["out"]["refused"]):
                raise AssertionError("the gate refused other txs than the forged ones")
    finally:
        reference.terminate()
        reference.join()
        gateway._default_verifier, gateway._default_hasher = saved
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    launches = {k: card[0]["launches"][k] + card[1]["launches"][k] for k in ("b1", "dsm", "ripemd160", "merkle_tree")}
    log({"phase": "committee_plane", **tag, "validators": n, "heights": last, "launches": launches,
         "forged_precommit": card[0]["out"]["forged"], "formats": [r["format"] for r in card[1]["records"]]})
    return {"setup": setup, "runs": {"card": card[0], "host": ref[0]}, "launches": launches}


def _committee_time_row(run: dict, heights: int) -> dict:
    """Phase 32's numbers of one session."""
    segs: dict[str, float] = {}
    for t in run["traces"]:
        for k, v in t["segments"].items():
            segs[k] = segs.get(k, 0.0) + v
    return {"wall_s": run["out"]["wall_s"], "blocks_per_sec": heights / run["out"]["wall_s"],
            "pump_sign_s": run["out"]["sign_s"], "segments_s": segs,
            "per_height": [{"height": t["height"], "wall_s": t["wall_s"], "segments": t["segments"]}
                           for t in run["traces"]],
            "vote_plane": run["vote_plane"], "pipeline": run["pipeline"]}


def committee_time(name, power, ctx) -> None:
    """Phase 32: the times of phase 31's first sessions, the card node's and
    the host reference's, each on a fresh home committing heights
    1..COMMITTEE_HEIGHTS: blocks_per_sec (benches/bench_committee.py's
    name), the consensus trace's segments a height and summed, the vote
    plane's batches, batched signatures, singletons and
    consensus_vote_verify_batch_seconds, the pipeline's join wait and
    overlap, and the pump's own signing seconds (the node's share is the
    rest). One run each: a second pair took 21 s on the card and 60-77 s
    on the host (its four pure-Python checks of a 401-lane aggregate a
    height), more than phases 31-32's clock allows."""
    tag = {"card": name, "power_limit": power}
    setup, runs = ctx["setup"], ctx["runs"]
    rows = {label: _committee_time_row(run, COMMITTEE_HEIGHTS) for label, run in runs.items()}
    for label, row in rows.items():
        log({"phase": "committee_time", **tag, "node": label, "heights": COMMITTEE_HEIGHTS,
             "validators": len(setup.keys), **row})
    log({"phase": "committee_time", **tag, "speedup": rows["host"]["wall_s"] / rows["card"]["wall_s"]})


# -- phases 33-34: the gossip (the gossip_net cell) ------------------------------


def make_gossip_inputs(pool, rng) -> list[dict]:
    """Phase 33's bursts, from their own generator so the earlier phases'
    draws stay as they were: one a height, of phase 31's families."""
    return make_bursts(pool, rng, GOSSIP_HEIGHTS, COMMITTEE_FIRST_BLOCK, COMMITTEE_BLOCK,
                       COMMITTEE_VALUE_BYTES, EXEC_SIGNERS, b"gsp-%07d")


def gossip_genesis(p, keys, powers: dict[bytes, int]):
    """The gossip net's genesis: `keys` at power 1 but the four nodes'
    addresses at `powers`, default ConsensusParams, the upgrade to aggregate
    commits at GOSSIP_UPGRADE_HEIGHT."""
    return p.GenesisDoc(
        genesis_time_ns=BLOCK_TIME_NS, chain_id=CHAIN_ID,
        validators=[p.GenesisValidator(k.pub_key(), powers.get(k.pub_key().address(), 1)) for k in keys],
        upgrade_height=GOSSIP_UPGRADE_HEIGHT, upgrade_format="aggregate",
    )


def gossip_power(p, keys) -> tuple[list[bytes], dict[bytes, int], dict[int, bytes]]:
    """(V0-V3's addresses, their powers, the proposer of each height). The
    nodes are the keys at GOSSIP_NODE_KEYS (address order) at
    GOSSIP_NODE_POWER, found by a search over three keys a third apart,
    their roles and V0-V2's power, from the largest down, with V3 the
    power-1 key the rotation then elects last, and checked here on the
    ported ValidatorSet's rotation: the four hold
    less than two thirds of the total (no height commits without the
    stubs); height 1's proposer is V1 (burst 1 is fed to it before the net
    starts) or a stub; each of V0-V2 proposes in 1..GOSSIP_HEIGHTS; and
    V3 proposes, but only after it has caught up and its mempool holds
    its burst (at GOSSIP_LATE_AFTER + 2 or later); and a stub is elected at
    GOSSIP_HEIGHTS + 1, so no node's next proposal (and no check of it) is
    in flight when the launches are read."""
    addrs = [keys[i].pub_key().address() for i in GOSSIP_NODE_KEYS]
    powers = dict(zip(addrs, GOSSIP_NODE_POWER))
    total = sum(GOSSIP_NODE_POWER) + len(keys) - 4
    sched = committee_schedule(p, gossip_genesis(p, keys, powers), GOSSIP_HEIGHTS)
    nxt = committee_schedule(p, gossip_genesis(p, keys, powers), GOSSIP_HEIGHTS + 1)[GOSSIP_HEIGHTS + 1]
    mine = [[h for h, a in sched.items() if a == addr] for addr in addrs]
    ok = (3 * sum(GOSSIP_NODE_POWER) < 2 * total and (sched[1] == addrs[1] or sched[1] not in addrs)
          and all(mine[:3]) and mine[3] and min(mine[3]) >= GOSSIP_LATE_AFTER + 2 and nxt not in addrs)
    if not ok:
        raise AssertionError(f"the gossip net's powers give the schedule {mine}")
    return addrs, powers, sched


def stub_relay():
    """The stubs' peer's reactor: the consensus reactor's channels and the
    mempool's, so every node can send it what it sends any peer; it drops
    what it receives, sends what the pump hands it, and tells each node it
    stands at height 1."""
    from tendermint_tpu_torch.consensus.messages import NewRoundStepMessage
    from tendermint_tpu_torch.consensus.reactor import STATE_CHANNEL, ConsensusReactor, _enc
    from tendermint_tpu_torch.consensus.round_state import RoundStep
    from tendermint_tpu_torch.mempool.reactor import MempoolReactor
    from tendermint_tpu_torch.p2p import Reactor

    class StubRelay(Reactor):
        def __init__(self):
            self.peers: dict[str, object] = {}
            self.received = 0

        def start(self):
            pass

        def stop(self):
            pass

        def get_channels(self):
            return ConsensusReactor.get_channels(None) + MempoolReactor.get_channels(None)

        def add_peer(self, peer):
            self.peers[peer.node_info.moniker] = peer
            # stand at height 1: a node's mempool reactor then holds the
            # txs of height 3 on (mempool/reactor.py's peer-height rule),
            # which the stubs would only drop
            peer.send(STATE_CHANNEL, _enc(NewRoundStepMessage(1, 0, RoundStep.NEW_HEIGHT, 0, -1)))

        def remove_peer(self, peer, reason):
            self.peers.pop(peer.node_info.moniker, None)

        def receive(self, ch_id, peer, msg):
            self.received += len(msg)

    return StubRelay()


class gossip_switch:
    """A port Switch wired as node/node.py wires one, on phase 29's p2p
    config (the rates and the 10 ms flush throttle in every peer's
    MConnConfig, secret connections on), a listener on 127.0.0.1 port 0 and
    NodeInfo with the genesis schedule, carrying `reactors`. Every
    stop_peer_for_error is recorded."""

    def __init__(self, doc, moniker: str, reactors: dict):
        from tendermint_tpu_torch.config.config import P2PConfig
        from tendermint_tpu_torch.p2p import MConnConfig, NodeInfo, PeerConfig, Switch
        from tendermint_tpu_torch.p2p.listener import Listener
        from tendermint_tpu_torch.p2p.node_info import default_version
        from tendermint_tpu_torch.version import VERSION

        cfg = P2PConfig(**FASTSYNC_P2P)
        self.sw = Switch(cfg, PeerConfig(mconfig=MConnConfig(
            send_rate=float(cfg.send_rate), recv_rate=float(cfg.recv_rate),
            flush_throttle=cfg.flush_throttle_timeout)))
        for rname, reactor in reactors.items():
            self.sw.add_reactor(rname, reactor)
        self.listener = Listener("127.0.0.1:0")
        self.sw.add_listener(self.listener)
        self.sw.set_node_info(NodeInfo(
            pub_key=self.sw.node_priv_key.pub_key(), moniker=moniker, network=doc.chain_id,
            version=default_version(VERSION), listen_addr=str(self.listener.internal_address()),
            other=["consensus_version=v1", f"commit_schedule={doc.schedule_string()}"]))
        self.stops: list[tuple[str, str]] = []
        stop_peer = self.sw.stop_peer_for_error

        def recording_stop(peer, reason):
            self.stops.append((peer.node_info.moniker, str(reason)))
            stop_peer(peer, reason)

        self.sw.stop_peer_for_error = recording_stop

    def port(self) -> int:
        return self.listener.internal_address().port

    def dial(self, other: "gossip_switch"):
        from tendermint_tpu_torch.p2p import NetAddress

        return self.sw.dial_peer_with_address(NetAddress("127.0.0.1", other.port()))

    def bytes_sent(self) -> int:
        return sum(peer.mconn.send_monitor.status().bytes for peer in self.sw.peers.list())


class gossip_node:
    """One port validator of the gossip net: committee_node (sqlite stores
    with the kv tx index, the signed kvstore on 4 shards behind AppConns
    with the Handshaker, the gated Mempool with its WAL, the consensus WAL,
    pipeline_apply, its own `Verifier` and the shared `Hasher`) with a
    MempoolReactor and a ConsensusReactor(fast_sync=False) on a
    gossip_switch. Every state the node saves is recorded (the state DB's
    writes of the state key), and so are the votes its consensus reactor
    receives, by sender, and the aggregate catch-up commits it screens."""

    def __init__(self, p, name: str, root: str, doc, verifier, hasher, shared_log):
        from tendermint_tpu_torch.consensus import messages as cmsgs
        from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
        from tendermint_tpu_torch.mempool.reactor import MempoolReactor

        self.name = name
        self.log = verify_log(verifier)
        self.node = committee_node(p, root, doc, verifier, hasher, self.log, tx_index=True)
        self.states: list[bytes] = []
        db = self.node.dbs["state"]
        set_sync = db.set_sync

        def recording_set_sync(key, value):
            if key == b"stateKey" and (not self.states or self.states[-1] != value):
                self.states.append(bytes(value))
            return set_sync(key, value)

        db.set_sync = recording_set_sync
        self.con_r = ConsensusReactor(self.node.cs, fast_sync=False)
        self.con_r.set_event_switch(self.node.evsw)
        self.mem_r = MempoolReactor(p.test_config().mempool, self.node.mempool)
        self.votes_in: dict[str, int] = {}
        self.screens: list[tuple[int, str, bool]] = []
        receive, screen = self.con_r.receive, self.con_r._screen_agg_commit

        def counting_receive(ch_id, peer, msg_bytes):
            if ch_id == 0x22:
                who = peer.node_info.moniker
                self.votes_in[who] = self.votes_in.get(who, 0) + 1
            return receive(ch_id, peer, msg_bytes)

        def tagged_screen(peer, msg: cmsgs.AggregateCommitMessage):
            with shared_log.tagged_aggregate("screen"):
                ok = screen(peer, msg)
            self.screens.append((msg.height, peer.node_info.moniker, ok))
            return ok

        self.con_r.receive = counting_receive
        self.con_r._screen_agg_commit = tagged_screen
        self.switch = gossip_switch(doc, name, {"MEMPOOL": self.mem_r, "CONSENSUS": self.con_r})
        self.node.started = False  # the consensus reactor starts and stops the state
        self.started = False
        # the pump is prompt, but the first three wait at height
        # GOSSIP_LATE_AFTER + 1 while V3 catches up: no round may time out
        cc = self.node.cs.config
        cc.timeout_propose = cc.timeout_prevote = cc.timeout_precommit = 10 * GOSSIP_WAIT_S

    def start(self) -> None:
        """Start the switch: its consensus reactor starts the state."""
        self.switch.sw.start()
        self.started = True

    def own_vote(self, h: int, type_: int) -> bool:
        """Whether the node's own vote of `type_` at (h, round 0) is in."""
        cs = self.node.cs
        if cs.rs.height > h:
            return True
        if cs.rs.height < h or cs.rs.votes is None:
            return False
        idx, _ = cs.rs.validators.get_by_address(self.node.pv.get_address())
        vs = cs.rs.votes.prevotes(0) if type_ == 1 else cs.rs.votes.precommits(0)
        return vs is not None and vs.get_by_index(idx) is not None

    def applied(self, h: int) -> bool:
        """Height h - 1 is committed and applied, and the node is at h."""
        cs = self.node.cs
        return (cs.rs.height == h and cs._pending_apply is None and not cs._state_provisional
                and cs.state.last_block_height == h - 1)


def thread_cpu() -> dict[str, float]:
    """CPU seconds of this process's threads so far (Linux
    /proc/self/task), summed by thread name (the part before a ':' or a
    number); threads that have ended are not counted."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out: dict[str, float] = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        name = re.split(r"[:\-(]| \d", names.get(int(tid), "unnamed"))[0]
        out[name] = out.get(name, 0.0) + (int(fields[11]) + int(fields[12])) / tick
    return out


class catchup_watch:
    """Polls a catching-up node's consensus state every 5 ms and keeps,
    for each height, when the node entered it, when its block's parts were
    complete and when it was stored."""

    def __init__(self, node):
        self.node = node
        self.entered: dict[int, float] = {}
        self.parts: dict[int, float] = {}
        self.stored: dict[int, float] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="catchup_watch")
        self._thread.start()

    def _run(self) -> None:
        cs, store = self.node.cs, self.node.store
        while not self._stop.is_set():
            now = time.perf_counter()
            rs = cs.rs
            h = rs.height
            self.entered.setdefault(h, now)
            bp = rs.proposal_block_parts
            if bp is not None and bp.is_complete():
                self.parts.setdefault(h, now)
            for sh in range(max(self.stored, default=0) + 1, store.height() + 1):
                self.stored[sh] = now
            time.sleep(0.005)

    def stop(self) -> dict[int, dict]:
        self._stop.set()
        self._thread.join(5)
        out = {}
        for h, t in self.stored.items():
            start = self.entered.get(h)
            if start is None:
                continue
            parts = self.parts.get(h, t)
            out[h] = {"parts_s": parts - start, "commit_s": t - parts, "total_s": t - start}
        return out


def gossip_reference(root: str, doc_json, last: int, sample: int, wait_s: float, waves: bool = False) -> dict:
    """Phase 33's host reference, in a process of its own: V0's stored chain
    replayed from genesis, height by height as V0 stores it (its sqlite
    files, read beside the node), through the ported execution path on
    Verifier(device="cpu") (its gate sends every lane to the native CPU
    floor, the aggregate LastCommits to the host's reference check) and
    host_hasher(): each block h is proved by the next block's LastCommit
    (V0's seen commit for the last), then validate_block and apply_block
    run it, into a fresh signed kvstore on 4 shards over MemDBs with the
    kv tx index. Returns every state saved, the tx-index records of each
    block's first `sample` txs, each block's part-set root and tx root
    recomputed on the host against its block id and header, the seconds
    the replay worked (its waits for V0 left out), and the launches
    (none). With `waves`, the app's state tree hands its commit waves to a
    host Hasher as a node's tree hands them to the node's (statetree's
    _hash_batch: a wave of 32 nodes or more), and "waves" holds each
    height's widths (the sharded fold's key priorities, which also reach
    that Hasher, left out: an unsharded app hashes them key by key)."""
    from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.libs.db import MemDB, db_provider
    from tendermint_tpu_torch.merkle.simple import simple_hash_from_byteslices
    from tendermint_tpu_torch.ops.gateway import Verifier
    from tendermint_tpu_torch.proxy import AppConns, LocalClientCreator
    from tendermint_tpu_torch.state import apply_block
    from tendermint_tpu_torch.state.execution import validate_block
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.state.txindex import KVTxIndexer
    from tendermint_tpu_torch.types.genesis import GenesisDoc
    from tendermint_tpu_torch.types.part_set import PartSet
    from tendermint_tpu_torch.types.tx import tx_hash
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.types.services import MockMempool
    from tendermint_tpu_torch.types.tx import set_batch_tx_root
    from tendermint_tpu_torch.types.agg_commit import commit_is_aggregate

    reset_launches()
    doc = GenesisDoc.from_json(doc_json)
    db = db_provider("blockstore", "sqlite", root)
    states: list[bytes] = []

    def stored(height: int):
        """V0's store once it holds `height` (a store object reads the
        height when it is made)."""
        deadline = time.monotonic() + wait_s
        while True:
            store = BlockStore(db)
            if store.height() >= height:
                return store
            if time.monotonic() > deadline:
                raise AssertionError(f"host replay: V0 stored no height {height} in {wait_s} s")
            time.sleep(0.05)

    class recording_db(MemDB):
        def set_sync(self, key, value):
            if key == b"stateKey" and (not states or states[-1] != value):
                states.append(bytes(value))
            return super().set_sync(key, value)

    busy = 0.0
    with routed_to():
        verifier = Verifier(min_tpu_batch=APP_REF_GATE, device="cpu")
        gateway._default_verifier, gateway._default_hasher = verifier, host_hasher()
        set_batch_tx_root(None)
        state = State.get_state(recording_db(), doc)
        state.tx_indexer = KVTxIndexer(MemDB())
        app = SignedKVStoreApp(verify_in_app=False)
        app.deliver_verifier = verifier
        app.shards = APP_SHARDS
        widths: dict[int, list[int]] = {}
        applying = [0]  # the height apply_block runs
        if waves:
            tree_hasher = host_hasher()
            leaf_hashes = tree_hasher.part_leaf_hashes

            def recorded(chunks):
                if call_site("other") == "tree":  # not the sharded fold's key priorities
                    widths.setdefault(applying[0], []).append(len(chunks))
                return leaf_hashes(chunks)

            tree_hasher.part_leaf_hashes = recorded
            app.tree.hasher = tree_hasher
        conns = AppConns(LocalClientCreator(app))
        conns.start()
        part_size = doc.consensus_params.block_gossip.block_part_size_bytes
        roots, index = [], []
        try:
            for h in range(1, last + 1):
                store = stored(min(h + 1, last))
                t0 = time.perf_counter()
                block, meta = store.load_block(h), store.load_block_meta(h)
                proof = store.load_block(h + 1).last_commit if h < last else store.load_seen_commit(h)
                if commit_is_aggregate(proof):
                    proof.verify(doc.chain_id, state.validators)
                else:
                    state.validators.verify_commit(doc.chain_id, meta.block_id, h, proof)
                validate_block(state, block)
                parts = PartSet.from_data(block.to_bytes(), part_size)
                roots.append({"height": h, "parts": parts.header() == meta.block_id.parts_header,
                              "data_hash": simple_hash_from_byteslices(list(block.data.txs))
                              == block.header.data_hash})
                applying[0] = h
                apply_block(state, None, conns.consensus(), block, meta.block_id.parts_header, MockMempool())
                index.append([state.tx_indexer.get(tx_hash(tx)).to_json() for tx in block.data.txs[:sample]])
                busy += time.perf_counter() - t0
        finally:
            conns.stop()
            db.close()
    return {"states": states, "roots": roots, "index": index, "seconds": busy, "launches": read_launches(),
            "waves": widths}


def gossip_expected(doc, logs: dict, live: dict, caught: dict, proofs: dict, gate: int) -> dict:
    """The dispatches by source, and the launches, the chain implies for the
    net, from the code's call sites (consensus/state.py,
    consensus/reactor.py, state/execution.py, the signed kvstore):

    - a LastCommit check of block h (h >= 2) at each node: four at a
      height the node voted in (validate_block at the prevote, the lock,
      finalize and in apply_block), two at a height it caught up on
      (finalize and apply_block); "aggregate" (dsm, n + 1 lanes) from the
      upgrade height on, else "commit" (B1);
    - one "aggregate" more a height a node finalized from an aggregate
      commit proof (ConsensusState.apply_commit_proof), and one "screen"
      (dsm) for each AggregateCommitMessage its reactor screened at its
      own height (recorded: a second peer's copy can land before the node
      moves on);
    - one "deliver" (B1) a height each node applied;
    - "vote", "gate" and "one" as recorded: the micro-batches of a node's
      receive routine and the gate's batches (both batch by time), and the
      lone signatures (a vote left single, a proposal).

    Every dispatch is counted, whatever its width; of them, one of `gate`
    lanes or more is one launch (B1, or dsm for "aggregate" and
    "screen"), and a smaller one verifies on the native CPU floor."""
    want = {"commit": 0, "aggregate": 0, "screen": 0, "deliver": 0, "vote": 0, "gate": 0, "one": 0}
    for name in live:
        for heights, checks in ((live[name], 4), (caught.get(name, ()), 2)):
            for h in heights:
                if h >= 2:
                    want["aggregate" if doc.aggregate_commits_at(h) else "commit"] += checks
        want["deliver"] += len(live[name]) + len(caught.get(name, ()))
        want["aggregate"] += len(proofs.get(name, ()))
    calls = [c for log in logs.values() for c in log]
    for src in ("screen", "vote", "gate", "one"):
        want[src] = sum(1 for s, _n in calls if s == src)
    got = {}
    for src, _n in calls:
        got[src] = got.get(src, 0) + 1
    agg = ("aggregate", "screen")
    return {"want": want, "got": got,
            "b1": sum(1 for src, n in calls if n >= gate and src not in agg),
            "dsm": sum(1 for src, n in calls if n >= gate and src in agg),
            "tpu_sigs": sum(n for src, n in calls if n >= gate and src not in ("aggregate", "screen")),
            "agg_lanes_device": sum(n for src, n in calls if n >= gate and src in ("aggregate", "screen")),
            "cpu_sigs": sum(n for src, n in calls if n < gate and src not in ("aggregate", "screen")),
            "agg_lanes_cpu": sum(n for src, n in calls if n < gate and src in ("aggregate", "screen"))}


def gossip_phase(name, power, seeds, bursts) -> dict:
    """Phase 33: the gossip on the card, in process. Four port validators
    V0-V3 of the gossip_net cell (gossip_node, each on its own
    Verifier(device=DEVICE), the card's Hasher shared and installed as the
    gateway's default beside a fifth Verifier for the aggregate checks and
    screens, the tx-root hook on the Hasher) on a full mesh of switches
    over TCP loopback with secret connections, and a fifth switch, the
    stubs' peer (stub_relay), dialled into every node. The pump drives
    heights 1..GOSSIP_HEIGHTS: a stub proposer's block is built from V0's
    mempool and state (as committee_pump builds it) and sent with its parts
    to every running node; once block h is out, burst h + 1 goes through
    the check_tx of V((h + 1) mod 3) (the others get it through the
    mempool reactor); once every running node has prevoted, the stubs'
    prevotes go out (stubs 0-47 to V0, 48-95 to V1: V2 and V3 hear the
    stubs by relay alone); once the mempool block h + 1 is built from holds
    burst h + 1 and every running node has precommitted, the stubs'
    precommits go out, stub 0's at GOSSIP_FORGED_HEIGHT with a flipped
    signature. V3 starts empty once V0-V2 have committed GOSSIP_LATE_AFTER
    and catches up through the consensus reactor's catch-up gossip before
    the pump goes on. The host reference (gossip_reference) replays V0's
    chain beside the net in a process of its own. Then the checks of
    phase 33 (PERF.md §4, the gossip_net cell)."""
    from tendermint_tpu_torch.consensus import messages as cmsgs
    from tendermint_tpu_torch.consensus.reactor import DATA_CHANNEL, VOTE_CHANNEL, _enc
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops.gateway import Hasher, Verifier
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.tx import tx_hash

    tag = {"card": name, "power_limit": power}
    p = committee_pkg()
    keys = sorted((p.gen_priv_key_ed25519(s) for s in seeds[:GOSSIP_VALIDATORS]),
                  key=lambda k: k.pub_key().address())
    addrs, node_powers, sched = gossip_power(p, keys)
    doc = gossip_genesis(p, keys, node_powers)
    total = sum(node_powers.values()) + len(keys) - 4
    stubs = [(i, p.PrivValidatorFS(k, None)) for i, k in enumerate(keys) if k.pub_key().address() not in addrs]
    names = ["V0", "V1", "V2", "V3"]
    proposers = {h: names[addrs.index(a)] if a in addrs else "stub" for h, a in sched.items()}
    log({"phase": "gossip_setup", **tag, "validators": len(keys), "node_power": list(GOSSIP_NODE_POWER),
         "total_power": total, "nodes_share": sum(GOSSIP_NODE_POWER) / total, "proposers": proposers,
         "upgrade_height": GOSSIP_UPGRADE_HEIGHT, "heights": GOSSIP_HEIGHTS,
         "late_after": GOSSIP_LATE_AFTER, "txs_per_height": [len(b["txs"]) for b in bursts],
         "forged_precommit_height": GOSSIP_FORGED_HEIGHT})
    saved = gateway._default_verifier, gateway._default_hasher
    roots, nodes, switches = [], {}, []
    reference = multiprocessing.get_context("spawn").Pool(1)
    stub_sw = None
    try:
        with routed_to():
            hasher = Hasher(device=DEVICE)
            default = Verifier(device=DEVICE)
            if default.kernel != "f32p" or hasher._route != "local":
                raise AssertionError(f"the card's routes: {default.kernel}, {hasher._route}")
            shared_log = verify_log(default)
            gateway._default_verifier, gateway._default_hasher = default, hasher
            ptx.set_batch_tx_root(hasher.tx_merkle_root)
            v0, h0 = default.stats(), hasher.stats()
            gc.collect()
            reset_launches()
            cpu0 = thread_cpu()
            t_start = time.perf_counter()

            def start_node(i: int) -> gossip_node:
                root = tempfile.mkdtemp(prefix=f"gossip-{names[i]}-")
                roots.append(root)
                key = next(k for k in keys if k.pub_key().address() == addrs[i])
                committee_home(p, root, key)
                g = gossip_node(p, names[i], root, doc, Verifier(device=DEVICE), hasher, shared_log)
                nodes[names[i]] = g
                switches.append(g.switch)
                return g

            for i in range(3):
                start_node(i)
            # the host replay follows V0's store from now on, in its own process
            pending = reference.apply_async(gossip_reference, (roots[0], doc.to_json(), GOSSIP_HEIGHTS,
                                                               GOSSIP_INDEX_SAMPLE, 10 * GOSSIP_WAIT_S))

            def running():
                return [g for g in nodes.values() if g.started]

            def wait(cond, what):
                deadline = time.monotonic() + GOSSIP_WAIT_S
                while not cond():
                    for g in running():
                        err = g.node.cs.device_error
                        if err is not None:
                            raise AssertionError(f"{g.name} stopped on a device error: {err}")
                    if time.monotonic() > deadline:
                        state = {g.name: (g.node.cs.rs.height, g.node.cs.rs.round_, int(g.node.cs.rs.step),
                                          g.node.mempool.size()) for g in running()}
                        raise AssertionError(f"gossip pump: waited {GOSSIP_WAIT_S} s for {what}: {state}")
                    time.sleep(0.002)  # the nodes share this interpreter: poll lightly

            refused = {}

            def pool_txs(mp) -> set[bytes]:
                """The txs in a mempool, read off its list without its lock
                (reap takes the lock and flushes the app connection)."""
                out, el = set(), mp.txs.front()
                while el is not None:
                    out.add(el.value.tx)
                    el = el.next()
                return out

            def feed(h: int) -> None:
                """Burst h through V(h mod 3)'s check_tx (the others get it
                through the mempool reactor)."""
                refused[h] = nodes[names[h % 3]].node.feed(bursts[h - 1]["txs"])

            def held(h: int) -> None:
                """Until the mempool height h's block is built from (the
                proposer's, or V0's for a stub's block) holds burst h's
                valid txs."""
                valid = {tx for i, tx in enumerate(bursts[h - 1]["txs"]) if i not in refused[h]}
                maker = nodes["V0" if proposers[h] == "stub" else proposers[h]]

                def holds():
                    time.sleep(0.05)
                    mp = maker.node.mempool
                    return mp.size() >= len(valid) and valid <= pool_txs(mp)

                wait(holds, f"burst {h} in {maker.name}'s mempool")

            feed(1)  # into V1 before the switches, and consensus, start
            held(1)
            relay = stub_relay()
            stub_sw = gossip_switch(doc, "stubs", {"STUBS": relay})
            stub_sw.sw.start()
            for i in range(3):
                nodes[names[i]].start()
            for i in range(3):
                for j in range(i + 1, 3):
                    nodes[names[i]].switch.dial(nodes[names[j]].switch)
                stub_sw.dial(nodes[names[i]].switch)

            wait(lambda: len(relay.peers) == 3 and all(g.switch.sw.peers.size() == 3 for g in running()),
                 "the first three nodes' peers")
            committed_at: dict[int, float] = {}
            watch = None
            catchup = {}
            forged = None
            steps: dict[int, dict[str, float]] = {}
            for h in range(1, GOSSIP_HEIGHTS + 1):
                wait(lambda: all(g.applied(h) for g in running()), f"height {h}")
                committed_at[h - 1] = time.perf_counter()
                if h > 1:
                    # the pump's steps of the height before: where the wall goes
                    steps[h - 1]["commit_s"] = committed_at[h - 1] - mark
                log({"phase": "gossip_height", "height": h, "t_s": committed_at[h - 1] - t_start,
                     "steps_before": steps.get(h - 1)})
                mark, steps[h] = time.perf_counter(), {}

                def step(name: str) -> None:
                    nonlocal mark
                    now = time.perf_counter()
                    steps[h][name] = now - mark
                    mark = now

                if proposers[h] == "stub":
                    cs = nodes["V0"].node.cs
                    commit = p.empty_commit() if h == 1 else cs._commit_for_proposal(cs.rs.last_commit.make_commit())
                    txs = cs.mempool.reap(cs.config.max_block_size_txs)
                    block, parts = p.Block.make_block(
                        height=h, chain_id=CHAIN_ID, txs=txs, commit=commit, prev_block_id=cs.state.last_block_id,
                        val_hash=cs.state.validators.hash(), app_hash=cs.state.app_hash,
                        part_size=doc.consensus_params.block_gossip.block_part_size_bytes,
                        time_ns=BLOCK_TIME_NS + h * 10**9)
                    pv = next(pv for _, pv in stubs if pv.get_address() == sched[h])
                    proposal = pv.sign_proposal(CHAIN_ID, p.Proposal(h, 0, parts.header()))
                    for g in running():
                        peer = relay.peers[g.name]
                        peer.send(DATA_CHANNEL, _enc(cmsgs.ProposalMessage(proposal)))
                        for i in range(parts.total):
                            peer.send(DATA_CHANNEL, _enc(cmsgs.BlockPartMessage(h, 0, parts.get_part(i))))
                else:
                    own = nodes[proposers[h]].node.cs
                    wait(lambda: own.rs.height > h or own.rs.proposal is not None, f"{proposers[h]}'s proposal at {h}")
                step("proposal_s")
                if h < GOSSIP_HEIGHTS:
                    # the next burst, once block h is out: its gossip runs
                    # beside this height's votes
                    feed(h + 1)
                    step("next_burst_fed_s")
                wait(lambda: all(g.own_vote(h, p.VOTE_TYPE_PREVOTE) for g in running()), f"the prevotes at {h}")
                step("prevotes_s")
                cs = nodes["V0"].node.cs
                bid = p.BlockID(cs.rs.proposal_block.hash(), cs.rs.proposal_block_parts.header())
                for type_ in (p.VOTE_TYPE_PREVOTE, p.VOTE_TYPE_PRECOMMIT):
                    votes = [pv.sign_vote(CHAIN_ID, p.Vote(pv.get_address(), i, h, 0, type_, bid)) for i, pv in stubs]
                    if type_ == p.VOTE_TYPE_PRECOMMIT and h == GOSSIP_FORGED_HEIGHT:
                        raw = bytearray(votes[0].signature.raw)
                        raw[5] ^= 0x20
                        votes[0] = votes[0].with_signature(p.SignatureEd25519(bytes(raw)))
                        forged = (h, votes[0].validator_index)
                    half = len(votes) // 2
                    for target, part in (("V0", votes[:half]), ("V1", votes[half:])):
                        peer = relay.peers[target]
                        for v in part:
                            peer.send(VOTE_CHANNEL, _enc(cmsgs.VoteMessage(v)))
                    if type_ == p.VOTE_TYPE_PREVOTE:
                        step("stub_prevotes_s")
                        if h < GOSSIP_HEIGHTS:
                            held(h + 1)
                            step("next_burst_held_s")
                        wait(lambda: all(g.own_vote(h, p.VOTE_TYPE_PRECOMMIT) for g in running()),
                             f"the precommits at {h}")
                        step("precommits_s")
                if h == GOSSIP_LATE_AFTER:
                    wait(lambda: all(g.applied(h + 1) for g in running()), f"height {h + 1}")
                    t_late = time.perf_counter()
                    late = start_node(3)
                    late.start()
                    watch = catchup_watch(late.node)
                    for i in range(3):
                        nodes[names[i]].switch.dial(late.switch)
                    stub_sw.dial(late.switch)
                    wait(lambda: late.applied(h + 1) and "V3" in relay.peers, "V3's catch-up")
                    catchup = watch.stop()
                    catchup_s = time.perf_counter() - t_late
                    log({"phase": "gossip_catchup", "seconds": catchup_s, "per_height": catchup})
            last = GOSSIP_HEIGHTS
            wait(lambda: all(g.applied(last + 1) and g.node.store.height() == last for g in running()),
                 "the last commit")
            committed_at[last] = time.perf_counter()
            steps[last]["commit_s"] = committed_at[last] - mark
            wall_s = time.perf_counter() - t_start
            stops = {sw.sw.node_info.moniker: list(sw.stops) for sw in switches + [stub_sw] if sw.stops}
            cpu = {k: v - cpu0.get(k, 0.0) for k, v in thread_cpu().items()}
            if DEVICE != "cpu":
                _sync()
            launches = read_launches()
            v1, h1 = default.stats(), hasher.stats()
            bytes_sent = sum(sw.bytes_sent() for sw in switches) + stub_sw.bytes_sent()
            node_stats = {}
            for g in running():
                cs = g.node.cs
                node_stats[g.name] = {
                    "verifier": g.node.cs.verifier.stats(),
                    "vote_plane": {"batches": cs.vote_batcher.batches, "batched_sigs": cs.vote_batcher.batched_sigs,
                                   "singletons": cs.vote_batcher.singletons},
                    "vote_duplicates": cs.vote_duplicates, "vote_accepted": cs.vote_accepted,
                    "has_votes_applied": g.con_r.has_votes_applied,
                    "part_announces_sent": g.con_r.part_announces_sent,
                    "part_announces_applied": g.con_r.part_announces_applied,
                    "agg_commits_sent": g.con_r.agg_commits_sent,
                    "agg_commits_rejected": g.con_r.agg_commits_rejected,
                    "votes_in": dict(g.votes_in), "screens": list(g.screens),
                    "proofs": list(g.node.flight.proofs),
                    "gate": {"fail_open": g.node.batcher.fail_open, "bad_sigs": g.node.batcher.bad_sigs,
                             "device_error": g.node.batcher.device_error},
                    "device_error": cs.device_error, "exceptions": list(g.node.flight.exceptions),
                    "rejects": [(r["height"], r["type"], r["err"].split(":")[0]) for r in g.node.flight.rejects],
                    "calls": g.log.take(), "gate_sizes": g.node.gate.take()[0],
                    "waves": g.node.rec.take()[0],
                    "traces": [t.to_json() for t in cs.trace.last(last)],
                }
        # stop the net: the stubs' peer, then each node's switch (its
        # consensus reactor stops the state, the deferred apply drained)
        stub_sw.sw.stop()
        for g in running():
            g.switch.sw.stop()
        records, index, finals = {}, {}, {}
        for g in running():
            node = g.node
            records[g.name] = node.records(1, last)
            st = node.cs.state
            index[g.name] = [[st.tx_indexer.get(tx_hash(tx)).to_json()
                              for tx in node.store.load_block(h).data.txs[:GOSSIP_INDEX_SAMPLE]]
                             for h in range(1, last + 1)]
            finals[g.name] = node.stop()
        ptx.set_batch_tx_root(None)
        t_ref = time.perf_counter()
        ref = pending.get(timeout=10 * GOSSIP_WAIT_S)
        ref_wall_s = time.perf_counter() - t_ref  # the replay's tail after the net stopped
    finally:
        reference.terminate()
        reference.join()
        ptx.set_batch_tx_root(None)
        gateway._default_verifier, gateway._default_hasher = saved
        if stub_sw is not None:
            stub_sw.sw.stop()
        for sw in switches:
            sw.sw.stop()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)

    # -- the checks ----------------------------------------------------------
    gate = default.min_tpu_batch
    want_records = records["V0"]
    for nm in names:
        # every stored record but the seen commit, which is each node's own
        diff = [r["height"] for r, w in zip(records[nm], want_records)
                if {k: v for k, v in r.items() if k != "seen"} != {k: v for k, v in w.items() if k != "seen"}]
        if diff:
            raise AssertionError(f"{nm}: heights {diff} differ from V0's")
        if index[nm] != index["V0"]:
            raise AssertionError(f"{nm}: tx-index records differ from V0's")
        st = nodes[nm].states
        if len(st) < last or st != ref["states"][-len(st):]:
            raise AssertionError(f"{nm}: saved states differ from the host reference's "
                                 f"({len(st)} against {len(ref['states'])})")
        if finals[nm] != ref["states"][-1]:
            raise AssertionError(f"{nm}: the final state differs from the host reference's")
    if index["V0"] != ref["index"]:
        raise AssertionError("the tx-index records differ from the host reference's")
    if not all(r["parts"] and r["data_hash"] for r in ref["roots"]):
        raise AssertionError(f"a block's part-set root or tx root differs on the host: {ref['roots']}")
    if any(ref["launches"].values()):
        raise AssertionError(f"the host reference launched kernels: {ref['launches']}")
    for h in range(1, last + 1):
        if len(p.Block.from_bytes(want_records[h - 1]["block"]).data.txs) != \
                len(bursts[h - 1]["txs"]) - len(bursts[h - 1]["forged"]):
            raise AssertionError(f"height {h} did not commit its burst")
        if want_records[h - 1]["parts_total"] < GOSSIP_MIN_PARTS:
            raise AssertionError(f"height {h}: {want_records[h - 1]['parts_total']} parts")
    # refusals: the forged precommit at V0 alone, the forged txs at the fed gate alone
    rejects = {nm: s["rejects"] for nm, s in node_stats.items()}
    if rejects != {"V0": [(GOSSIP_FORGED_HEIGHT, 2, "InvalidSignatureError")], "V1": [], "V2": [], "V3": []}:
        raise AssertionError(f"refused votes {rejects}: expected the forged precommit at V0 alone")
    if any(refused[h] != bursts[h - 1]["forged"] for h in refused):
        raise AssertionError("a gate refused other txs than the forged ones")
    fed_bad = {nm: 0 for nm in names}
    for h in refused:
        fed_bad[names[h % 3]] += len(refused[h])
    if {nm: s["gate"]["bad_sigs"] for nm, s in node_stats.items()} != fed_bad:
        raise AssertionError(f"gates saw forged txs other than their own: "
                             f"{ {nm: s['gate']['bad_sigs'] for nm, s in node_stats.items()} }")
    # the gossip did its work: at each height V2 and V3 voted in, their
    # seen commit holds stub precommits, which reach them by relay alone
    stub_addrs = {pv.get_address() for _, pv in stubs}
    for nm, heights in (("V2", range(1, last + 1)), ("V3", range(GOSSIP_LATE_AFTER + 1, last + 1))):
        for h in heights:
            seen = records[nm][h - 1]["seen"]
            signers = _seen_signers(p, seen, keys)
            if not signers & stub_addrs:
                raise AssertionError(f"{nm}'s quorum at height {h} holds no relayed stub vote")
        if node_stats[nm]["votes_in"].get("stubs"):
            raise AssertionError(f"{nm} heard a stub directly")
    agg_heights = [h for h in range(1, GOSSIP_LATE_AFTER + 1)
                   if doc.aggregate_commits_at(h + 1) and h <= GOSSIP_LATE_AFTER - 1]
    screened = sorted({h for h, _s, ok in node_stats["V3"]["screens"] if ok})
    if screened != agg_heights or sorted(node_stats["V3"]["proofs"]) != agg_heights:
        raise AssertionError(f"V3 screened {screened} and finalized from proofs at {node_stats['V3']['proofs']}, "
                             f"expected the aggregate heights {agg_heights}")
    if any(s["agg_commits_rejected"] for s in node_stats.values()) or \
            not any(node_stats[nm]["agg_commits_sent"] for nm in ("V0", "V1", "V2")):
        raise AssertionError(f"aggregate catch-up: {[(nm, s['agg_commits_sent'], s['agg_commits_rejected']) for nm, s in node_stats.items()]}")
    # nothing fell back
    for nm, s in node_stats.items():
        if s["device_error"] is not None or s["gate"]["device_error"] is not None or s["exceptions"]:
            raise AssertionError(f"{nm}: device error {s['device_error']} {s['gate']['device_error']} {s['exceptions']}")
        if s["gate"]["fail_open"]:
            raise AssertionError(f"{nm}: the gate failed open {s['gate']['fail_open']} times")
    if stops:
        raise AssertionError(f"peers stopped for errors: {stops}")
    # the launches
    live = {nm: list(range(1, last + 1)) for nm in ("V0", "V1", "V2")}
    live["V3"] = list(range(GOSSIP_LATE_AFTER + 1, last + 1))
    caught = {"V3": list(range(1, GOSSIP_LATE_AFTER + 1))}
    logs = {nm: s["calls"] for nm, s in node_stats.items()}
    logs["default"] = shared_log.take()
    exp = gossip_expected(doc, logs, live, caught, {nm: s["proofs"] for nm, s in node_stats.items()}, gate)
    sites = sorted(([*k, v] for k, v in shared_log.agg_sites.items()), key=lambda r: (r[1] or 0, r[0], r[3]))
    if exp["got"] != {k: v for k, v in exp["want"].items() if v}:
        raise AssertionError(f"dispatches by source {exp['got']}, expected {exp['want']}; aggregate checks "
                             f"(source, height, thread, callers, count): {sites}")
    waves = sum(w >= hasher.min_tpu_batch for s in node_stats.values() for w in s["waves"])
    own_parts = sum(1 for h in range(1, last + 1) if proposers[h] != "stub"
                    and want_records[h - 1]["parts_total"] >= hasher.min_tpu_batch)
    hs = {k: h1[k] - h0[k] for k in ("tpu_part_batches", "tpu_tx_roots", "tpu_leaves", "cpu_leaves",
                                     "tx_root_cache_hits")}
    if hs["tpu_part_batches"] != own_parts + waves or not last <= hs["tpu_tx_roots"] <= 5 * last:
        raise AssertionError(f"hasher {hs}: expected {own_parts} own part sets and {waves} waves, "
                             f"and {last} to {5 * last} tx roots")
    want_launches = {"b1": exp["b1"], "dsm": exp["dsm"], "ripemd160": hs["tpu_tx_roots"] + own_parts + waves,
                     "merkle_tree": hs["tpu_tx_roots"] + own_parts}
    _launch_delta(launches, want_launches, "gossip net")
    lanes = {k: sum(s["verifier"][k] for s in node_stats.values()) + (v1[k] - v0[k])
             for k in ("tpu_sigs", "cpu_sigs", "agg_lanes_device", "agg_lanes_cpu")}
    if (lanes["tpu_sigs"], lanes["agg_lanes_device"], lanes["cpu_sigs"], lanes["agg_lanes_cpu"]) != \
            (exp["tpu_sigs"], exp["agg_lanes_device"], exp["cpu_sigs"], exp["agg_lanes_cpu"]):
        raise AssertionError(f"verifier lanes {lanes}, expected {exp}")
    log({"phase": "gossip_path", **tag, "heights": last, "proposers": proposers, "launches": launches,
         "sources": exp["want"], "lanes": lanes, "hasher": hs, "waves_device": waves, "own_part_sets": own_parts,
         "agg_catchup_heights": agg_heights, "forged_precommit": forged, "aggregate_sites": sites,
         "formats": [r["format"] for r in want_records], "records": "equal on V0-V3 and to the host replay"})
    return {"launches": launches, "node_stats": node_stats, "committed_at": committed_at, "wall_s": wall_s,
            "catchup": catchup, "catchup_s": catchup_s, "bytes_sent": bytes_sent, "ref": ref,
            "ref_wall_s": ref_wall_s, "gate": gate, "shared": logs["default"], "relay_bytes": relay.received,
            "steps": steps, "thread_cpu_s": dict(sorted(cpu.items(), key=lambda kv: -kv[1])[:12])}


def _seen_signers(p, seen_json, keys) -> set[bytes]:
    """The validator addresses whose precommits a stored seen commit holds
    (a full commit's precommits, or an aggregate's signers)."""
    from tendermint_tpu_torch.types.agg_commit import commit_from_json

    commit = commit_from_json(seen_json)
    if hasattr(commit, "signers"):
        return {keys[i].pub_key().address() for i in commit.signers.indices()}
    return {pc.validator_address for pc in commit.precommits if pc is not None}


def gossip_time(name, power, ctx) -> None:
    """Phase 34: phase 33's run (one run, as §4's cuts): the net's blocks/s
    over heights 2..GOSSIP_HEIGHTS, each node's trace segments a height; its
    vote batches (the widths, how many reached the card, the singletons,
    the votes it received direct from the stubs' peer and relayed by the
    nodes), the duplicate-vote ratio (consensus_vote_duplicates /
    consensus_vote_accepted, as benches/bench_localnet.py reads it),
    has_votes_applied and the part announces; the bytes a height over the
    net; V3's catch-up seconds a height, split into parts and commit; and
    the host replay's seconds beside the card's (not a rate)."""
    tag = {"card": name, "power_limit": power}
    at = ctx["committed_at"]
    last = GOSSIP_HEIGHTS
    gate = ctx["gate"]
    log({"phase": "gossip_time", **tag, "heights": [2, last],
         "blocks_per_sec": (last - 1) / (at[last] - at[1]), "wall_s": ctx["wall_s"],
         "height_s": {h: at[h] - at[h - 1] for h in range(2, last + 1)},
         "bytes_per_height": ctx["bytes_sent"] / last, "stub_sink_bytes": ctx["relay_bytes"],
         "catchup_s": ctx["catchup_s"], "catchup_per_height": ctx["catchup"], "pump_steps": ctx["steps"],
         "thread_cpu_s": ctx["thread_cpu_s"],
         "host_replay_s": ctx["ref"]["seconds"], "host_replay_tail_s": ctx["ref_wall_s"]})
    for nm, s in ctx["node_stats"].items():
        votes = [n for src, n in s["calls"] if src == "vote"]
        segs: dict[str, float] = {}
        for t in s["traces"]:
            for k, v in t["segments"].items():
                segs[k] = segs.get(k, 0.0) + v
        log({"phase": "gossip_node", **tag, "node": nm, "vote_batch_widths": votes,
             "vote_batches_on_card": sum(1 for n in votes if n >= gate), **s["vote_plane"],
             "votes_direct": s["votes_in"].get("stubs", 0),
             "votes_relayed": sum(v for k, v in s["votes_in"].items() if k != "stubs"),
             "duplicate_ratio": s["vote_duplicates"] / max(1, s["vote_accepted"]),
             "vote_duplicates": s["vote_duplicates"], "vote_accepted": s["vote_accepted"],
             "has_votes_applied": s["has_votes_applied"], "part_announces_sent": s["part_announces_sent"],
             "part_announces_applied": s["part_announces_applied"], "agg_commits_sent": s["agg_commits_sent"],
             "gate_batches": len(s["gate_sizes"]), "segments_s": segs,
             "per_height": [{"height": t["height"], "wall_s": t["wall_s"], "segments": t["segments"]}
                            for t in s["traces"]]})
    hist = _hist_reading()
    log({"phase": "gossip_time", **tag, "vote_verify_batches_process": hist["vote_batch"][0],
         "consensus_vote_verify_batch_seconds_process": hist["vote_batch"][1]})


# -- phases 35-36: RPC, the light client and state sync ---------------------------------


def make_statesync_inputs(pool, rng) -> list[dict]:
    """Node A's bursts for the state_sync cell, from their own generator:
    STATESYNC_HEIGHTS of them in fast sync's families (see make_bursts)."""
    return make_bursts(pool, rng, STATESYNC_HEIGHTS, FASTSYNC_FIRST_BLOCK, FASTSYNC_BLOCK,
                       FASTSYNC_VALUE_BYTES, FASTSYNC_SIGNERS, b"ssync-%07d")


class tampered_snapshots:
    """A SnapshotStore whose first chunk served comes back with one byte
    flipped (the middle byte, bit 0)."""

    def __init__(self, store):
        self.store = store
        self.flipped = None

    def __getattr__(self, attr):
        return getattr(self.store, attr)

    def load_chunk(self, height: int, index: int):
        chunk = self.store.load_chunk(height, index)
        if chunk is not None and self.flipped is None:
            self.flipped = index
            raw = bytearray(chunk)
            raw[len(raw) // 2] ^= 0x01
            chunk = bytes(raw)
        return chunk


def serve_statesync(root: str, doc_json, tamper: bool, conn) -> None:
    """A state-sync serving node in a process of its own, on node A's files
    under `root`: the sqlite `state` and `blockstore` behind a p2p_node
    (BlockchainReactor(fast_sync=False)) with a StateSyncReactor serving
    the SnapshotStore under root/snapshots and an RPCServer on 127.0.0.1
    port 0 over the store, the state and an app: a SignedKVStoreApp on the
    host (its tree hashed by the host, its block verify on a Verifier whose
    gate sends every lane to the native CPU floor) loaded with A's app
    state at the height before the last (STATESYNC_APP_FILE), the last
    stored block then replayed into it as a Handshaker replays a block its
    app lacks, so that proofs at the height before the last verify against
    the last header. The RPC carries an EventSwitch, so that a replica
    following A can subscribe to NewBlock (the chain is static: the
    subscription idles). With `tamper` (peer D) the snapshot store flips
    one byte of the first chunk it serves, and no RPC is served. Sends
    (p2p port, node id, RPC address), then serves until told to stop."""
    from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp
    from tendermint_tpu_torch.blockchain import BlockStore
    from tendermint_tpu_torch.libs.db import db_provider
    from tendermint_tpu_torch.libs.events import EventSwitch
    from tendermint_tpu_torch.ops.gateway import Verifier
    from tendermint_tpu_torch.proxy import AppConns, LocalClientCreator
    from tendermint_tpu_torch.rpc.core import RPCContext
    from tendermint_tpu_torch.rpc.server import RPCServer
    from tendermint_tpu_torch.state import State, exec_commit_block
    from tendermint_tpu_torch.statesync import SnapshotStore
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    doc = GenesisDoc.from_json(doc_json)
    dbs = {n: db_provider(n, "sqlite", root) for n in ("state", "blockstore")}
    store = BlockStore(dbs["blockstore"])
    state = State.load_state(dbs["state"], doc)
    snaps = SnapshotStore(os.path.join(root, "snapshots"))
    node = p2p_node(doc, state, store, None, False, "D" if tamper else "A")
    node.sw.add_reactor("STATESYNC", StateSyncReactor(tampered_snapshots(snaps) if tamper else snaps))
    conns = rpc = evsw = None
    try:
        if not tamper:
            app = SignedKVStoreApp(verify_in_app=False)
            app.deliver_verifier = Verifier(min_tpu_batch=APP_REF_GATE, device="cpu")
            app.shards = APP_SHARDS
            with open(os.path.join(root, STATESYNC_APP_FILE), "rb") as f:
                app.restore(f.read())
            conns = AppConns(LocalClientCreator(app))
            conns.start()
            exec_commit_block(conns.consensus(), store.load_block(store.height()))
            if app.app_hash != state.app_hash:
                raise AssertionError("A's app, replayed to the last height, differs from A's state")
            evsw = EventSwitch()
            evsw.start()
            rpc = RPCServer("tcp://127.0.0.1:0", RPCContext(
                event_switch=evsw, block_store=store, proxy_app_query=conns.query(), genesis_doc=doc,
                state=state, switch=node.sw))
            rpc.start()
        node.start()
        conn.send((node.listener.internal_address().port, node.node_id(),
                   f"127.0.0.1:{rpc.port}" if rpc else None))
        conn.recv()
        conn.send(node.stops)
    finally:
        node.close()
        if rpc is not None:
            rpc.stop()
        if evsw is not None:
            evsw.stop()
        if conns is not None:
            conns.stop()
        for db in dbs.values():
            db.close()


def warm_statesync_imports() -> None:
    """The imports a phase-35 process needs, done while A is built."""
    import torch  # noqa: F401

    from tendermint_tpu_torch.abci.apps import signedkv  # noqa: F401
    from tendermint_tpu_torch.ops import gateway  # noqa: F401
    from tendermint_tpu_torch.rpc import light, server  # noqa: F401
    from tendermint_tpu_torch.statesync import reactor, restore  # noqa: F401


def serve_statesync_later(conn) -> None:
    """serve_statesync on the (root, genesis JSON, tamper) it is sent."""
    warm_statesync_imports()
    serve_statesync(*conn.recv(), conn)


class statesync_server(serving_process):
    """serve_statesync in a spawned process, started before A is built
    (its imports meanwhile) and given A's files by serve(); the servers of
    phase 35 load their apps side by side; ready() waits for its port,
    node id and RPC address; close() is serving_process's."""

    def __init__(self):
        self._spawn(serve_statesync_later, ())

    def serve(self, root: str, doc, tamper: bool = False) -> None:
        self.conn.send((root, doc.to_json(), tamper))

    def ready(self) -> "statesync_server":
        self.port, self.node_id, self.rpc = self._first_message()
        return self


class statesync_node:
    """Node C of the state_sync cell (C' on the host's floor), empty, wired
    as node/node.py:540-597 wires a restoring node, in a temp directory of
    its own: sqlite `state`, `blockstore` and `tx_index`, a SignedKVStoreApp
    on APP_SHARDS shards (verify_in_app off, its block verify through
    `verifier`, its tree through `hasher` by a wave_recorder), a LightClient
    over rpc.client.HTTPClient to A's RPC trusting the genesis set with the
    verifier's commit_batch_verifier, a Restorer on `hasher` and that batch
    verifier, a StateSyncReactor armed with it whose on_complete hands the
    restored state to BlockchainReactor.start_after_statesync, and a
    p2p_node whose BlockchainReactor waits for the restore
    (defer_for_statesync) and then fast-syncs the tail on the verifier and
    the hasher as fastsync_node wires them. sync() starts the switch."""

    def __init__(self, doc, verifier, hasher, rpc_addr: str, label: str):
        from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp
        from tendermint_tpu_torch.blockchain import BlockStore
        from tendermint_tpu_torch.libs.db import db_provider
        from tendermint_tpu_torch.proxy import AppConns, LocalClientCreator
        from tendermint_tpu_torch.rpc.client import HTTPClient
        from tendermint_tpu_torch.rpc.light import LightClient
        from tendermint_tpu_torch.state import State
        from tendermint_tpu_torch.state.txindex import KVTxIndexer
        from tendermint_tpu_torch.statesync import Restorer, SnapshotStore
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
        from tendermint_tpu_torch.types.validator import Validator
        from tendermint_tpu_torch.types.validator_set import ValidatorSet

        self.doc, self.verifier, self.hasher = doc, verifier, hasher
        self.root = tempfile.mkdtemp(prefix="statesync-")
        self.dbs = {n: db_provider(n, "sqlite", self.root) for n in ("state", "blockstore", "tx_index")}
        self.state = State.get_state(self.dbs["state"], doc)
        self.state.tx_indexer = KVTxIndexer(self.dbs["tx_index"])
        self.store = BlockStore(self.dbs["blockstore"])
        self.app = SignedKVStoreApp(verify_in_app=False)
        self.rec = wave_recorder(hasher)
        self.app.tree.hasher = self.rec
        self.app.deliver_verifier = verifier
        self.app.shards = APP_SHARDS
        self.conns = AppConns(LocalClientCreator(self.app))
        self.conns.start()
        self.gate = batch_recorder(verifier)
        self.applied: list[float] = []
        self.marks: dict[str, float] = {}
        self.node = p2p_node(doc, self.state, self.store, self.conns.consensus(), True, label,
                             batch_verifier=verifier.commit_batch_verifier(),
                             async_batch_verifier=self.gate.verify_batch_async,
                             part_hasher=hasher.part_leaf_hashes, part_tree_hasher=hasher.part_set_tree,
                             post_apply_hook=lambda state, block: self.applied.append(time.perf_counter()),
                             defer_for_statesync=True)
        vs = ValidatorSet([Validator.new(v.pub_key, v.power) for v in doc.validators])
        self.light = LightClient(HTTPClient(rpc_addr), doc.chain_id, vs, trusted_height=0,
                                 batch_verifier=verifier.commit_batch_verifier())
        self.restorer = Restorer(doc, self.app, self.dbs["state"], self.store, hasher=hasher,
                                 light_client=self.light, batch_verifier=verifier.commit_batch_verifier())
        self.ss = StateSyncReactor(SnapshotStore(os.path.join(self.root, "snapshots")), self.restorer,
                                   enabled=True, on_complete=self._on_complete)
        self.node.sw.add_reactor("STATESYNC", self.ss)
        switch_to_consensus = self.node.consensus.switch_to_consensus

        def switched(state):
            switch_to_consensus(state)
            self.marks.setdefault("switched", time.perf_counter())

        self.node.consensus.switch_to_consensus = switched
        # the bytes a stopped peer moved, read before the switch drops it
        self.stopped_bytes = 0
        stop_peer = self.node.sw.stop_peer_for_error

        def counted_stop(peer, reason):
            self.stopped_bytes += peer.mconn.recv_monitor.status().bytes
            stop_peer(peer, reason)

        self.node.sw.stop_peer_for_error = counted_stop
        self.loop_done = threading.Event()
        loop = self.node.bc._pool_routine

        def pool_routine():
            try:
                loop()
            finally:
                self.loop_done.set()

        self.node.bc._pool_routine = pool_routine
        self.started = False

    def _on_complete(self, state) -> None:
        """node/node.py's _on_statesync_complete: the restored state to the
        fast-sync reactor, which then syncs the tail."""
        t = time.perf_counter()
        self.restored = None if state is None else state.bytes_()
        self.marks["restored"] = t
        self.node.bc.start_after_statesync(state)

    def sync(self, *serving: tuple[int, str]) -> dict:
        """Start the switch, dial the serving nodes' (port, node id) in
        order (after the first, once it is a peer), then wait for the
        switch to consensus, or the restore's or the sync's error, within
        STATESYNC_SYNC_S. The tx-root hook and the gateway's default
        verifier (an aggregate commit's, in the light walk and the tail)
        are this node's for the run. The stages are clocked: discovery
        (_pick_snapshot), the manifest with the light walk and its commit
        checks (_fetch_manifest, LightClient._verify_with), the download
        and its 8-chunk window checks (the reactor's verify_chunk_batch,
        whose widths are recorded), the restore (Restorer.restore) with
        the whole-manifest check (verify_chunks), the app's restore (its tree build, the Hasher's calls
        by the wave recorder) and the seed; the tail from the handoff."""
        from tendermint_tpu_torch.ops import gateway
        from tendermint_tpu_torch.rpc.light import LightClient
        from tendermint_tpu_torch.statesync import Restorer
        from tendermint_tpu_torch.statesync import reactor as ss_reactor
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
        from tendermint_tpu_torch.types import tx as ptx

        bc = self.node.bc
        windows: list[int] = []
        window_s = [0.0]
        window_check = ss_reactor.verify_chunk_batch

        def recorded_window(manifest, items, hasher=None):
            t = time.perf_counter()
            try:
                return window_check(manifest, items, hasher=hasher)
            finally:
                windows.append(len(items))
                window_s[0] += time.perf_counter() - t

        saved = gateway._default_verifier
        gateway._default_verifier = self.verifier
        ptx.set_batch_tx_root(self.hasher.tx_merkle_root)
        ss_reactor.verify_chunk_batch = recorded_window
        waves0 = len(self.rec.widths)
        try:
            with stage_clock(discovery=(StateSyncReactor, "_pick_snapshot"),
                             manifest=(StateSyncReactor, "_fetch_manifest"),
                             walk_verify=(LightClient, "_verify_with"),
                             download=(StateSyncReactor, "_download_chunks"),
                             restore=(Restorer, "restore"), manifest_verify=(Restorer, "verify_chunks"),
                             app_restore=(type(self.app), "restore"), seed=(Restorer, "_seed")) as clk:
                t0 = time.perf_counter()
                self.node.start()
                self.started = True
                for i, (port, node_id) in enumerate(serving):
                    if i:
                        first = serving[0][1]
                        wait_for(lambda: self.node.sw.peers.get(first) is not None, STATESYNC_SYNC_S,
                                 "the first peer")
                    self.node.dial(port)
                wait_for(lambda: "switched" in self.marks or self.ss.sync_error is not None
                         or bc.sync_error is not None or ("restored" in self.marks and self.restored is None),
                         STATESYNC_SYNC_S, f"the state sync (store at {self.store.height()})")
        finally:
            ss_reactor.verify_chunk_batch = window_check
            gateway._default_verifier = saved
            ptx.set_batch_tx_root(None)
        for err, what in ((self.ss.sync_error, "the restore"), (bc.sync_error, "the tail's fast sync")):
            if err is not None:
                raise AssertionError(f"{what} stopped: {err!r}")
        if self.restored is None:
            raise AssertionError("the restore fell back to fast sync from genesis")
        sec = clk.seconds
        restored, switched = self.marks["restored"], self.marks["switched"]
        tail_blocks = len(self.applied)
        waves = self.rec.widths[waves0:]
        recv = self.stopped_bytes + sum(p.mconn.recv_monitor.status().bytes for p in self.node.sw.peers.list())
        return {
            "wall_s": switched - t0, "discovery_s": sec["discovery"],
            "manifest_and_walk_s": sec["manifest"], "walk_verify_s": sec["walk_verify"],
            "download_s": sec["download"] - window_s[0], "window_verify_s": window_s[0],
            "manifest_verify_s": sec["manifest_verify"],
            "restore_s": sec["restore"], "restore_split_s": {
                "manifest_verify": sec["manifest_verify"], "app_restore": sec["app_restore"],
                "seed": sec["seed"]},
            "restore_waves": len(waves), "restore_hasher_s": self.rec.seconds,
            "handoff_to_switch_s": switched - restored, "tail_blocks": tail_blocks,
            "tail_blocks_per_s": tail_blocks / (switched - restored), "bytes_received": recv,
            "windows": windows, "waves": waves, "stage_s": dict(bc.stage_s),
        }

    def records(self, snap_h: int, target: int, keys: list[bytes]) -> dict:
        return statesync_records(self.store, self.node.bc.state, self.app, snap_h, target, keys)

    def close(self) -> None:
        self.node.close()
        if "restored" in self.marks:  # start_after_statesync started the sync loop
            if not self.loop_done.wait(STATESYNC_SYNC_S):
                raise AssertionError("the fast-sync loop did not end")
        self.conns.stop()
        for db in self.dbs.values():
            db.close()
        shutil.rmtree(self.root, ignore_errors=True)


def statesync_records(store, state, app, snap_h: int, target: int, keys: list[bytes], seen=None) -> dict:
    """What a node holds from the snapshot height up: its store's base and
    height, the blocks, metas and LastCommits (`load_block_commit`) of
    heights snap_h..target, the seen commits (`seen(h)`, or the store's),
    the state's bytes and app hash, and the app's values of `keys`. (No
    tx-index entries: the restored State carries the null indexer, as on
    a node wired by node/node.py, so the tail's txs are not indexed.)"""
    seen = seen or (lambda h: store.load_seen_commit(h))
    return {
        "base": store.base(), "height": store.height(),
        "blocks": [store.load_block(h).to_bytes() for h in range(snap_h, target + 1)],
        "metas": [store.load_block_meta(h).to_json() for h in range(snap_h, target + 1)],
        "commits": [store.load_block_commit(h).to_json() for h in range(snap_h, target)],
        "seen": [seen(h).to_json() for h in range(snap_h, target + 1)],
        "state": state.bytes_(), "app_hash": state.app_hash,
        "values": [app.state.get(k.decode("latin-1")) for k in keys],
    }


def statesync_expected(doc, snap_h: int, target: int, n_vals: int, chunks: int, seen_full: bool,
                       waves: list[int], groups: list[int], delivered: int, windows: list[int],
                       hash_gate: int) -> dict:
    """The launches and lanes C's state sync implies. The light walk checks
    the commit of each height 1..snap_h + 1 (a block's commit is stored
    with its successor: aggregate from the upgrade on), B1 for a full one
    and dsm for an aggregate one; the restore checks the seen commit at
    snap_h (B1 if full, dsm if not); the download digests each window of
    chunks and the restore the whole manifest, one K1 launch a batch at or
    above the Hasher's gate (on the card's default gate of 16 the windows
    of 8 hash on the host, counted in its cpu_leaves); the app's restore hands its tree's waves of 32 or more to the
    Hasher (K1 each); the tail snap_h + 1..target is phase 29's sync
    (fastsync_expected's terms: B1 a group of full commits, a full
    LastCommit at apply, a deliver; dsm an aggregate proof and an
    aggregate LastCommit at apply; K1 and K3 a part set and a tx root a
    block, K1 the commit waves)."""
    walk = range(1, snap_h + 2)
    walk_full = sum(not doc.aggregate_commits_at(h + 1) for h in walk)
    walk_agg = len(walk) - walk_full
    tail = range(snap_h + 1, target + 1)
    full_apply = sum(not doc.aggregate_commits_at(h) for h in tail)
    agg_apply = len(tail) - full_apply
    agg_proof = sum(doc.aggregate_commits_at(h + 1) for h in tail)
    b1_commits = walk_full + int(seen_full) + full_apply
    dsm = walk_agg + int(not seen_full) + agg_proof + agg_apply
    batches = [chunks] + windows  # the whole-manifest check and the windows, each one digest batch
    on_card = sum(n >= hash_gate for n in batches)
    return {
        "launches": {"b1": b1_commits + len(groups) + len(tail), "dsm": dsm,
                     "ripemd160": on_card + len(waves) + 2 * len(tail), "merkle_tree": 2 * len(tail)},
        "lanes": {"tpu_sigs": n_vals * b1_commits + sum(groups) + delivered, "cpu_sigs": 0,
                  "agg_lanes_device": (n_vals + 1) * dsm, "agg_lanes_cpu": 0},
        "hasher": {"cpu_leaves": sum(n for n in batches if n < hash_gate), "tpu_tx_roots": len(tail)},
    }


def statesync_reference(doc_json, port: int, node_id: str, rpc_addr: str, snap_h: int, target: int,
                        keys: list[bytes], knobs: dict, conn) -> None:
    """C', the host reference, in a process of its own beside C: a
    statesync_node on a Verifier whose gate sends every lane to the native
    CPU floor (installed as the default verifier: the aggregate commits on
    the host's reference check) and host_hasher(), syncing from A's files
    alone (a serve_statesync process of its own: C and C' share no
    server's CPU).
    Sends "ready", syncs on the word, then sends its run, launches, lanes
    and records. `knobs` are the parent's STATESYNC_* values."""
    from tendermint_tpu_torch.ops.gateway import Verifier
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    globals().update(knobs)
    doc = GenesisDoc.from_json(doc_json)
    with routed_to():
        ref_v = Verifier(min_tpu_batch=APP_REF_GATE, device="cpu")
        node = statesync_node(doc, ref_v, host_hasher(), rpc_addr, "C-host")
        try:
            conn.send("ready")
            conn.recv()
            reset_launches()
            run = node.sync((port, node_id))
            launches = read_launches()
            out = {"run": run, "launches": launches, "stops": node.node.stops,
                   "lanes": {k: ref_v.stats()[k] for k in ("tpu_sigs", "cpu_sigs", "agg_lanes_device",
                                                           "agg_lanes_cpu")},
                   "records": node.records(snap_h, target, keys)}
        except BaseException as exc:
            out = {"error": f"{type(exc).__name__}: {exc}"}
        finally:
            node.close()
    conn.send(out)


def statesync_reference_later(conn) -> None:
    """statesync_reference on the arguments it is sent."""
    warm_statesync_imports()
    statesync_reference(*conn.recv(), conn)


def replica_expected(doc, last: int, last_full: bool, n_vals: int) -> dict:
    """The launches and lanes a replica's walk from genesis to `last`
    implies, and a client's walk over the replica too. rpc/light.py
    `advance` checks each height's commit in turn (it skips heights only
    past a pruned gap that /status attests, and A prunes nothing): the
    commit of h < last is block h + 1's LastCommit (aggregate from the
    upgrade on), the commit of `last` the seen commit (`last_full`). A
    full commit is one B1 launch of its n_vals lanes (the light client's
    batch_verifier), an aggregate one a dsm launch of n_vals + 1 lanes
    (AggregateCommit.verify on the default Verifier). The reads at
    last - 1 check their proofs against header `last`, which the walk
    left in the light client's header memo: no launch."""
    full = sum(not doc.aggregate_commits_at(h + 1) for h in range(1, last)) + int(last_full)
    agg = last - full
    return {"launches": {"b1": full, "dsm": agg},
            "lanes": {"tpu_sigs": n_vals * full, "cpu_sigs": 0, "agg_lanes_device": (n_vals + 1) * agg,
                      "agg_lanes_cpu": 0}}


def replica_run(verifier, upstream: str, target: int, last: int, present: list[bytes], absent: list[bytes],
                wanted: dict, proofs: dict, exp: dict) -> dict:
    """A port ReplicaDaemon in this process, upstream A's RPC, on
    `verifier` (the card's), installed as the gateway's default for the
    replica's whole life: the replica takes the default when it is built,
    and aggregate commits reach it through AggregateCommit.verify. The
    launches and lanes are set to 0 just before it is built and read after
    its walk to `last` and its own reads, and equal `exp`. It serves the
    present and absent keys at `target` over its own RPC abci_query, and
    through a LightClient pointed at it (whose walk over the replica's
    re-served commits is counted apart, and equals `exp` too): each value
    A's (`wanted`), each proof the one C verified over A's RPC (`proofs`).
    Under TENDERMINT_REPLICA_TAMPER=value, then =proof, that client's
    verified_query refuses every key, no kernel launches and the
    replica's verified counters and the Verifier's lanes do not move.
    Returns the launches, lanes, stats and times."""
    from tendermint_tpu_torch.config.toml import ensure_root
    from tendermint_tpu_torch.merkle.statetree_proof import TreeProof
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.replica import ReplicaDaemon
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.rpc.light import LightClient, LightClientError

    keys = present + absent

    def check_read(how: str, k: bytes, value, absent_: bool, height: int, proof_json) -> None:
        c = proofs[k]
        want = None if k in absent else wanted[k]
        if (value, absent_, height, proof_json) != (want, k in absent, target, c["proof"].to_json()) or \
                (c["value"], c["absent"], c["height"]) != (want, k in absent, target):
            raise AssertionError(f"the replica's {how} of {k!r} at {height}: {value!r}, absent {absent_}; "
                                 f"A's value {want!r}, C's proof at {c['height']}")

    home = tempfile.mkdtemp(prefix="replica-")
    cfg = ensure_root(home)
    cfg.replica.upstream = upstream
    cfg.replica.laddr = "tcp://127.0.0.1:0"
    saved = gateway._default_verifier
    gateway._default_verifier = verifier
    rep = None
    try:
        v0 = verifier.stats()
        gc.collect()
        reset_launches()
        t0 = time.perf_counter()
        rep = ReplicaDaemon(cfg)
        if rep.verifier is not verifier:
            raise AssertionError("the replica did not take the card's Verifier")
        ingest, ingest_s = rep._ingest, {}

        def timed_ingest(h: int) -> None:
            t = time.perf_counter()
            ingest(h)
            ingest_s[h] = time.perf_counter() - t

        rep._ingest = timed_ingest  # the follower's catch-up calls it per height
        rep.start()
        deadline = time.monotonic() + REPLICA_WAIT_S
        while rep._ingested < last and rep.device_error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        walk_s = time.perf_counter() - t0
        if rep.device_error is not None:
            raise AssertionError(f"the replica's follower stopped: {rep.device_error!r}")
        if rep._ingested != last or rep.light.height != last or rep.proof_verify_failures:
            raise AssertionError(f"the replica: ingested {rep._ingested}, trust at {rep.light.height} of {last}, "
                                 f"{rep.proof_verify_failures} proof failures")
        rpc = HTTPClient(f"127.0.0.1:{rep.rpc_port}")
        rpc_ms = []
        for k in keys:
            t = time.perf_counter()
            resp = rpc.abci_query(data=k.hex(), path="", height=target, prove=True)["response"]
            rpc_ms.append(1e3 * (time.perf_counter() - t))
            proof_json = json.loads(bytes.fromhex(resp["proof"]))
            check_read("abci_query", k, bytes.fromhex(resp["value"]) if resp.get("value") else None,
                       not TreeProof.from_json(proof_json).is_membership, resp["height"], proof_json)
        launches = read_launches()
        v1 = verifier.stats()
        lanes = {k: v1[k] - v0[k] for k in exp["lanes"]}
        _launch_delta(launches, exp["launches"], "the replica")
        if lanes != exp["lanes"]:
            raise AssertionError(f"the replica's lanes {lanes}, expected {exp['lanes']}")
        served = rep.stats()
        # a client pointed at the replica walks its re-served commits
        reset_launches()
        t0 = time.perf_counter()
        lc = LightClient.from_genesis(rpc, batch_verifier=verifier.commit_batch_verifier())
        client_ms = []
        for k in keys:
            t = time.perf_counter()
            r = lc.verified_query(k, height=target)
            client_ms.append(1e3 * (time.perf_counter() - t))
            check_read("verified_query", k, r["value"], r["absent"], r["height"], r["proof"].to_json())
        client_s = time.perf_counter() - t0
        client_launches = read_launches()
        _launch_delta(client_launches, exp["launches"], "a client's walk over the replica")
        # a lying replica is refused by the client; nothing is verified again
        watched = ("height", "proof_verify_failures", "cache_misses", "cache_entries", "cache_invalidations")
        before = {k: rep.stats()[k] for k in watched}, {k: verifier.stats()[k] for k in exp["lanes"]}
        reset_launches()
        refused = dict.fromkeys(("value", "proof"), 0)
        for mode in refused:
            os.environ["TENDERMINT_REPLICA_TAMPER"] = mode
            try:
                for k in keys:
                    try:
                        lc.verified_query(k, height=target)
                    except LightClientError:
                        refused[mode] += 1
            finally:
                del os.environ["TENDERMINT_REPLICA_TAMPER"]
        tamper_launches = read_launches()
        after = {k: rep.stats()[k] for k in watched}, {k: verifier.stats()[k] for k in exp["lanes"]}
        if refused != dict.fromkeys(refused, len(keys)) or after != before:
            raise AssertionError(f"tampered reads: refused {refused} of {len(keys)}; replica and Verifier "
                                 f"{before} -> {after}")
        _launch_delta(tamper_launches, {}, "the tampered reads")
        r = lc.verified_query(present[0], height=target)  # the knob corrupts at serve time only
        check_read("clean verified_query", present[0], r["value"], r["absent"], r["height"], r["proof"].to_json())
        # the follower's idle WS read times out every 10 s on a static chain
        # and resubscribes (upstream_reconnects), so the connection check
        # may read False for its backoff; the others hold throughout
        health = rep.health_view()
        if not all(health["checks"][c]["ok"] for c in ("bootstrapped", "lag", "device")):
            raise AssertionError(f"the replica's health: {health}")
        stats = rep.stats()
    finally:
        if rep is not None:
            rep.stop()
        gateway._default_verifier = saved
        shutil.rmtree(home, ignore_errors=True)
    return {"launches": launches, "lanes": lanes, "client_launches": client_launches, "refused": refused,
            "served": served, "stats": stats, "health": health["status"], "walk_s": walk_s, "ingest_s": ingest_s, "rpc_ms": rpc_ms,
            "client_s": client_s, "client_ms": client_ms}


def statesync_phase(name, power, vs, seed_of, bursts, entries: dict[bytes, bytes]) -> dict:
    """Phase 35: RPC, the light client and state sync on the card. Node A
    (an exec_chain on the default Verifier and Hasher) holds `entries`
    (phase 25's 250,000 keys) from genesis: its app's tree is loaded with
    them before the first block and the genesis app hash is their root. It
    builds STATESYNC_HEIGHTS heights of `bursts` with a SnapshotProducer
    (64 KiB chunks, full snapshots) taking STATESYNC_SNAPSHOT_HEIGHT, and
    keeps its app state at the height before the last
    (STATESYNC_APP_FILE). A serves its files from a process of its own
    (serve_statesync: the state-sync and fast-sync reactors and the RPC);
    D, a second process on the same files, serves the snapshot with one
    byte flipped. In this process node C (a statesync_node on
    Verifier(device=DEVICE) and a fresh Hasher(device=DEVICE)) dials D,
    then A, over TCP with secret connections, light-verifies the manifest
    through A's RPC, downloads, restores and fast-syncs the tail to A's
    height less one, then switches to consensus once; the host reference
    C' does the same, from a second honest process on A's files, in a
    process of its own at the same
    time. The launches are set to 0 just before C's dial and read just
    after, and equal statesync_expected; C and C' hold A's records, state,
    app hash, tx-index entries and sampled values; D is stopped once, for
    the chunk it flipped, and A stays; sampled present and absent keys
    verify through LightClient.verified_query against A's RPC. Then a
    port ReplicaDaemon follows A's RPC on C's Verifier (replica_run): its
    launches, read apart from C's, equal replica_expected, and its reads
    equal A's values and C's proofs. Returns what phase 36 reports, the
    launches and the replica's."""
    import torch

    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops.gateway import Hasher, Verifier
    from tendermint_tpu_torch.statesync import SnapshotProducer, SnapshotStore
    from tendermint_tpu_torch.statetree import VersionedTree
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.agg_commit import commit_is_aggregate

    tag = {"card": name, "power_limit": power}
    dev_type = torch.device(DEVICE).type
    snap_h, n_vals = STATESYNC_SNAPSHOT_HEIGHT, vs.size()
    rng = np.random.default_rng(SEED + 35)
    t_phase = time.perf_counter()
    marks: dict[str, float] = {}

    def mark(what: str) -> None:
        marks[what] = time.perf_counter() - t_phase

    # A's server, D, the mirror for C' and C' itself start now and import
    # while A is built; they get A's files after
    rctx = multiprocessing.get_context("spawn")
    servers = [statesync_server() for _ in range(3)]
    conn, child = rctx.Pipe()
    reference = rctx.Process(target=statesync_reference_later, daemon=True, args=(child,))
    reference.start()
    with routed_to():
        gateway._default_verifier = gateway._default_hasher = None
        t0 = time.perf_counter()
        tree = VersionedTree.from_entries(entries, 0, hasher=gateway.default_hasher())
        doc = exec_genesis(vs, FASTSYNC_UPGRADE_HEIGHT)
        doc.app_hash = tree.root_hash()
        a = exec_chain(doc, gateway.default_verifier(), gateway.default_hasher())
        tree.hasher = a.rec
        a.app.tree, a.app.app_hash = tree, doc.app_hash
        a.app.state = {k.decode("latin-1"): v for k, v in entries.items()}
        genesis_s = time.perf_counter() - t0
        producer = SnapshotProducer(SnapshotStore(os.path.join(a.root, "snapshots")), a.app, a.store,
                                    hasher=a.hasher, interval=snap_h, full_every=1)
        try:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(processes=min(8, os.cpu_count() or 1)) as pool:
                for height, burst in enumerate(bursts, 1):
                    gate = a.burst(burst["txs"], burst["forged"])
                    if gate["refused"] != burst["forged"]:
                        raise AssertionError(f"A height {height}: refused {gate['refused']}")
                    block, parts, _ = a.build(height)
                    if parts.total < a.hasher.min_tpu_batch:
                        raise AssertionError(f"A height {height}: {parts.total} parts, under the Hasher's gate")
                    a.apply(block, parts)
                    a.save(seed_of, block, parts, pool)
                    producer.maybe_snapshot(a.state)
                    if height == len(bursts) - 1:
                        with open(os.path.join(a.root, STATESYNC_APP_FILE), "wb") as f:
                            f.write(a.app.snapshot())
                        target_state = a.state.bytes_(), a.state.app_hash
                        burst_keys = sorted({k.encode("latin-1") for k in a.app.state} - set(entries))
                        state_keys = sorted(entries)
                        half = STATESYNC_SAMPLE_KEYS // 2
                        keys = ([state_keys[i] for i in rng.choice(len(state_keys), half, replace=False)]
                                + [burst_keys[i] for i in rng.choice(len(burst_keys), half, replace=False)])
                        values = [a.app.state.get(k.decode("latin-1")) for k in keys]
            ptx.set_batch_tx_root(None)
            height_a = a.store.height()
            target = height_a - 1
            if producer.snapshots_taken != 1 or producer.store.heights() != [snap_h]:
                raise AssertionError(f"A's snapshots: {producer.store.heights()}, "
                                     f"{producer.snapshot_failures} failed")
            manifest = producer.store.load_manifest(snap_h)
            seen_full = not commit_is_aggregate(a.store.load_seen_commit(snap_h))
            last_full = not commit_is_aggregate(a.store.load_seen_commit(height_a))
            tail_txs = sum(len(a.store.load_block(h).data.txs) for h in range(snap_h + 1, target + 1))
            want = statesync_records(a.store, a.state, a.app, snap_h, target, keys,
                                     seen=lambda h: (a.store.load_seen_commit(h) if h == snap_h
                                                     else a.store.load_block(h + 1).last_commit))
            want["state"], want["app_hash"] = target_state
            want["values"] = values
            want["base"], want["height"] = snap_h, target
            chain = {"validators": n_vals, "heights": height_a, "upgrade_height": FASTSYNC_UPGRADE_HEIGHT,
                     "state_keys": len(entries), "genesis_app_hash": doc.app_hash.hex(),
                     "genesis_load_s": genesis_s, "snapshot_height": snap_h, "chunks": manifest.chunks,
                     "snapshot_bytes": manifest.total_bytes, "chunk_bytes": producer.chunk_size,
                     "snapshot_s": producer.last_snapshot_seconds,
                     "formats": [a.store.load_block(h).commit_format() for h in range(2, height_a + 1)],
                     "build_s": time.perf_counter() - t0}
        except BaseException:
            for s in servers:
                s.proc.kill()
            reference.kill()
            raise
        finally:
            a.close()
        mark("a_built")
        log({"phase": "statesync_chain", **tag, **chain})
        c = None
        try:
            server, tampered, mirror = servers  # the mirror: A's files for C', so C and C' share no server
            for s in servers:
                s.serve(a.root, doc, tamper=s is tampered)
            for s in servers:
                s.ready()
            mark("servers_ready")
            knobs = {k: v for k, v in globals().items() if k.startswith("STATESYNC_")}
            conn.send((doc.to_json(), mirror.port, mirror.node_id, mirror.rpc, snap_h, target, keys, knobs))
            # C on the card: the main path, its launches and lanes counted
            verifier = Verifier(device=DEVICE)
            if verifier.kernel != "f32p" or verifier.device is None or verifier.device.type != dev_type:
                raise AssertionError(f"C's Verifier: kernel {verifier.kernel}, device {verifier.device}")
            hasher = Hasher(device=DEVICE)
            if hasher._route != "local":
                raise AssertionError(f"C's Hasher: route {hasher._route}")
            c = statesync_node(doc, verifier, hasher, server.rpc, "C")
            if not conn.poll(STATESYNC_SYNC_S) or conn.recv() != "ready":
                raise AssertionError("the host reference did not start")
            mark("reference_ready")
            v0, h0 = verifier.stats(), hasher.stats()
            gc.collect()
            conn.send("go")
            reset_launches()
            run = c.sync((tampered.port, tampered.node_id), (server.port, server.node_id))
            launches = read_launches()
            mark("c_switched")
            v1, h1 = verifier.stats(), hasher.stats()
            groups = [n for n in c.gate.sizes if n]
            exp = statesync_expected(doc, snap_h, target, n_vals, manifest.chunks, seen_full, run["waves"],
                                     groups, tail_txs, run["windows"], hasher.min_tpu_batch)
            lanes = {k: v1[k] - v0[k] for k in exp["lanes"]}
            hashed = {k: h1[k] - h0[k] for k in exp["hasher"]}
            bc = c.node.bc
            if c.store.height() != target or bc.blocks_synced != target - snap_h or \
                    c.node.consensus.switched != [want["state"]]:
                raise AssertionError(f"C: store at {c.store.height()}, synced {bc.blocks_synced}, "
                                     f"switched {len(c.node.consensus.switched)} times")
            bans = c.node.stops
            if len(bans) != 1 or bans[0][0] != tampered.node_id or "digest mismatch" not in bans[0][1] \
                    or c.ss.offerer_bans_corrupt != 1 or c.ss.peers_banned != 1:
                raise AssertionError(f"the tampered peer: stops {bans}, {c.ss.stats()}")
            if [p.id() for p in c.node.sw.peers.list()] != [server.node_id]:
                raise AssertionError("the tampered peer: A dropped")
            _launch_delta(launches, exp["launches"], "C's state sync")
            if lanes != exp["lanes"] or hashed != exp["hasher"]:
                raise AssertionError(f"C's lanes {lanes} and Hasher {hashed}, expected {exp['lanes']} "
                                     f"and {exp['hasher']}")
            got = c.records(snap_h, target, keys)
            if got != want:
                raise AssertionError(f"C differs from A in {[k for k in got if got[k] != want[k]]}")
            # C', beside C
            if not conn.poll(STATESYNC_SYNC_S):
                raise AssertionError("the host reference did not end")
            ref = conn.recv()
            mark("reference_done")
            if "error" in ref:
                raise AssertionError(f"the host reference: {ref['error']}")
            _launch_delta(ref["launches"], {}, "C' (host reference)")
            if ref["records"] != want or ref["stops"]:
                raise AssertionError(f"C' differs from A in "
                                     f"{[k for k in want if ref['records'][k] != want[k]]}, stops {ref['stops']}")
            if ref["lanes"]["tpu_sigs"] or ref["lanes"]["agg_lanes_device"]:
                raise AssertionError(f"C' verified on a device: {ref['lanes']}")
            # proofs of sampled present and absent keys over A's RPC, after
            # the launches were read (the walk goes on to target + 1)
            lc = c.restorer.light_client
            absent = [b"acct-absent-%03d" % i for i in range(STATESYNC_PROOF_KEYS)]
            present = keys[:STATESYNC_PROOF_KEYS // 2] + keys[-(STATESYNC_PROOF_KEYS // 2):]
            saved = gateway._default_verifier
            gateway._default_verifier = verifier
            try:
                proofs = {k: lc.verified_query(k, height=target) for k in present + absent}
            finally:
                gateway._default_verifier = saved
            wanted = dict(zip(keys, values))
            bad = [k for k in present if proofs[k]["absent"] or proofs[k]["value"] != wanted[k]] + \
                  [k for k in absent if not proofs[k]["absent"] or proofs[k]["value"] is not None]
            if bad or any(p["height"] != target for p in proofs.values()):
                raise AssertionError(f"verified queries against A's RPC: {bad}")
            mark("verified_queries")
            # the replica, on C's Verifier, after C's launches were read
            rep_exp = replica_expected(doc, height_a, last_full, n_vals)
            rep = replica_run(verifier, server.rpc, target, height_a, present, absent, wanted, proofs, rep_exp)
            mark("replica_done")
            log({"phase": "statesync_path", **tag, "node": "C", "route": {"verify": verifier.kernel,
                 "hash": hasher._route}, "snapshot_height": snap_h, "synced_to": c.store.height(),
                 "tail_blocks": run["tail_blocks"], "groups": groups, "launches": launches, "lanes": lanes,
                 "hasher": hashed, "tampered_peer": {"stops": [(pid[:12], why) for pid, why in bans],
                                                    "stats": {k: c.ss.stats()[k] for k in (
                                                        "peers_banned", "offerer_bans_corrupt", "chunks_fetched",
                                                        "chunk_failures")}},
                 "verified_queries": {"present": len(present), "absent": len(absent), "height": target},
                 "records": "equal to A's", **{k: v for k, v in run.items() if k not in ("waves", "windows")},
                 "window_widths": sorted(set(run["windows"])), "waves_k1": len(run["waves"])})
            log({"phase": "statesync_path", **tag, "node": "C-host", "lanes": ref["lanes"],
                 "records": "equal to A's", **{k: v for k, v in ref["run"].items() if k not in ("waves", "windows")}})
            log({"phase": "replica_path", **tag, "upstream": "A", "walked_to": height_a, "read_height": target,
                 "launches": rep["launches"], "replica_expected": rep_exp, "lanes": rep["lanes"],
                 "client_launches": rep["client_launches"], "reads": {"present": len(present), "absent": len(absent),
                                                                     "equal": "A's values, C's proofs"},
                 "tamper_refused": rep["refused"], "stats_after_walk_and_reads": rep["served"],
                 "stats": rep["stats"], "health": rep["health"]})
            log({"phase": "replica_time", **tag, "walk_s": rep["walk_s"], "ingest_s": rep["ingest_s"],
                 "rpc_read_ms": rep["rpc_ms"], "rpc_read_ms_median": statistics.median(rep["rpc_ms"]),
                 "client_walk_and_reads_s": rep["client_s"], "client_read_ms": rep["client_ms"],
                 "client_read_ms_median": statistics.median(rep["client_ms"])})
            mark("checked")
        finally:
            if c is not None:
                c.close()
            reference.join(DEVD_STOP_S)
            if reference.is_alive():
                reference.kill()
                reference.join()
            for s in servers:
                s.close()
    mark("closed")
    chunks = [producer.store.load_chunk(snap_h, i) for i in range(manifest.chunks)]
    shutil.rmtree(a.root, ignore_errors=True)
    log({"phase": "statesync_plane", **tag, "launches": launches, "verifier": verifier.stats(),
         "hasher": hasher.stats()})
    log({"phase": "statesync_marks", **tag, "s_since_phase_start": marks})
    return {"runs": {"card": run, "host": ref["run"]}, "chunks": chunks, "chain": chain,
            "launches": {k: launches[k] for k in ("b1", "dsm", "ripemd160", "merkle_tree")},
            "replica_launches": {k: rep["launches"][k] for k in ("b1", "dsm", "ripemd160", "merkle_tree")}}


def statesync_time(name, power, ctx) -> None:
    """Phase 36: phase 35's C and C' (one run each, beside each other): the
    sync's wall time from the dial to the switch to consensus and its
    split (discovery; the manifest with the light walk and its verify
    seconds; the download; the window checks and the whole-manifest
    check; the restore: the app's tree build with the Hasher's calls, the
    seed; the tail and its blocks/s), the bytes received; K1's device time
    on the whole-manifest digest batch; and the CRC-32C that frames each
    chunk on disk (snapshot.frame_chunk / unframe_chunk), on this host:
    the fallback without google_crc32c (crc32c_fallback) on one chunk and
    on every chunk, against the byte loop on one window of chunks, the
    values equal."""
    from tendermint_tpu_torch.libs import crc32c as crc
    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops import merkle as ops_merkle

    tag = {"card": name, "power_limit": power}
    runs = ctx["runs"]
    log({"phase": "statesync_time", **tag, **ctx["chain"],
         "card_run": {k: v for k, v in runs["card"].items() if k not in ("waves", "windows")},
         "host_run": {k: v for k, v in runs["host"].items() if k not in ("waves", "windows")},
         "speedup": runs["host"]["wall_s"] / runs["card"]["wall_s"],
         "restore_speedup": runs["host"]["restore_s"] / runs["card"]["restore_s"]})
    chunks = ctx["chunks"]
    words, first, nblocks = th.pack_ragged(chunks, True)
    args = th.to_device(words, first, nblocks, DEVICE)
    try:
        dev_ms = device_ms(lambda: th.ripemd160_lanes(*args), "hash_blocks_kernel")
    except RuntimeError:  # no device event in any trace: the CUDA events' time stands
        dev_ms = None
    t0 = time.perf_counter()
    ops_merkle.part_leaf_hashes(chunks, DEVICE)
    call_ms = 1e3 * (time.perf_counter() - t0)
    log({"phase": "statesync_time", **tag, "what": "k1_manifest_digests", "chunks": len(chunks),
         "bytes": sum(map(len, chunks)), "compressions": len(words), "device_ms": dev_ms,
         "kernel_ms": cuda_ms(lambda: th.ripemd160_lanes(*args)), "hasher_call_ms": call_ms})

    def byte_loop(data: bytes) -> int:
        return crc._register(0xFFFFFFFF, data) ^ 0xFFFFFFFF

    def best_s(fn, data, reps=3) -> float:
        out = []
        for _ in range(reps):
            t = time.perf_counter()
            fn(data)
            out.append(time.perf_counter() - t)
        return min(out)

    window = chunks[:8]
    if [crc.crc32c_fallback(ch) for ch in window] != [byte_loop(ch) for ch in window]:
        raise AssertionError("crc32c_fallback differs from the byte loop")
    t0 = time.perf_counter()
    for ch in chunks:
        crc.crc32c_fallback(ch)
    all_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for ch in window:
        byte_loop(ch)
    loop_window_s = time.perf_counter() - t0
    total = sum(map(len, chunks))
    log({"phase": "statesync_time", **tag, "what": "crc32c_frames", "impl": crc.IMPL,
         "chunk_bytes": len(chunks[0]), "chunk_fallback_ms": 1e3 * best_s(crc.crc32c_fallback, chunks[0]),
         "chunk_byte_loop_ms": 1e3 * best_s(byte_loop, chunks[0]), "snapshot_bytes": total,
         "snapshot_fallback_s": all_s, "window_bytes": sum(map(len, window)),
         "window_byte_loop_s": loop_window_s,
         "fallback_mb_s": total / all_s / 1e6,
         "byte_loop_mb_s": sum(map(len, window)) / loop_window_s / 1e6})


# -- phases 37-38: the node (the node_validator cell) ----------------------------


def make_node_inputs(pool, rng) -> list[dict]:
    """Phase 37's bursts, from their own generator so the earlier phases'
    draws stay as they were: one a height (the restart's included), of
    phase 31's families."""
    return make_bursts(pool, rng, NODE_HEIGHTS + NODE_RESTART_HEIGHTS, COMMITTEE_FIRST_BLOCK, COMMITTEE_BLOCK,
                       COMMITTEE_VALUE_BYTES, EXEC_SIGNERS, b"node-%07d")


class node_setup:
    """The node_validator cell's chain: phase 3's first NODE_VALIDATORS keys,
    the node's power from committee_power (it proposes height 1 and a
    height from the upgrade on, and none after NODE_HEIGHTS: the restart
    finds no proposal of its own in flight, and no proposal of its own
    follows the last height), the genesis and the bursts."""

    def __init__(self, seeds, bursts):
        self.p = committee_pkg()
        self.keys = sorted((self.p.gen_priv_key_ed25519(s) for s in seeds[:NODE_VALIDATORS]),
                           key=lambda k: k.pub_key().address())
        self.last = NODE_HEIGHTS + NODE_RESTART_HEIGHTS
        self.own, self.own_power, self.own_heights = committee_power(
            self.p, self.keys, NODE_HEIGHTS, NODE_UPGRADE_HEIGHT, idle=tuple(range(NODE_HEIGHTS + 1, self.last + 2)))
        self.own_key = next(k for k in self.keys if k.pub_key().address() == self.own)
        self.doc = committee_genesis(self.p, self.keys, self.own, self.own_power, NODE_UPGRADE_HEIGHT)
        self.bursts = bursts


def node_home(setup, root: str) -> str:
    """The node's home as its operator writes one: config.toml through the
    port's config/toml (the signed kvstore, so the gate is the SigBatcher;
    the kv tx index; sqlite; RPC and p2p on 127.0.0.1; PEX with its address
    book; no UPnP; a snapshot every NODE_SNAPSHOT_INTERVAL heights; no
    pruning; no fast sync, as the net's one live validator; generous
    liveness timeouts, and NODE_TIMEOUT_COMMIT before a started node's
    first height), genesis.json and priv_validator.json. Returns the
    node's database directory."""
    from tendermint_tpu_torch.config import default_config
    from tendermint_tpu_torch.config.toml import config_to_toml

    cfg = default_config()
    cfg.set_root(root)
    cfg.base.moniker = "node-validator"
    cfg.base.proxy_app = "signedkv"
    cfg.base.tx_index = "kv"
    cfg.base.db_backend = "sqlite"
    cfg.base.fast_sync = False
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex_reactor = True
    cfg.p2p.skip_upnp = True
    cfg.statesync.snapshot_interval = NODE_SNAPSHOT_INTERVAL
    cfg.pruning.retain_blocks = 0
    cc = cfg.consensus
    cc.timeout_commit = NODE_TIMEOUT_COMMIT
    cc.skip_timeout_commit = True
    cc.timeout_propose = cc.timeout_prevote = cc.timeout_precommit = 60.0
    os.makedirs(cfg.base.db_dir(), exist_ok=True)
    with open(os.path.join(root, "config.toml"), "w") as f:
        f.write(config_to_toml(cfg))
    setup.doc.save_as(cfg.base.genesis_file())
    setup.p.PrivValidatorFS(setup.own_key, cfg.base.priv_validator_file()).save()
    return cfg.base.db_dir()


# The node's Verifier and Hasher are called with no source tag, so phase 37
# names each call by where it runs: the gate's thread, or the first of these
# functions of the port on the caller's stack. The smoke depends on these
# internal names alone; a renamed one shows as an unexpected source, which
# node_expected refuses.
NODE_GATE_THREAD = "mempool.sigbatch"  # mempool/mempool.py, SigBatcher's thread
NODE_CALL_SITES = {
    "deliver_txs": "deliver",  # abci/apps/signedkv.py, a block's signatures
    "reconstruct_last_commit": "seen_commit",  # consensus/state.py, a restart's prime
    "_chunk_digests": "snapshot",  # statesync/producer.py, a snapshot's chunk digests
    "_hash_batch": "tree",  # statetree/tree.py, one commit wave
    "from_data": "parts",  # types/part_set.py, a part set's host leaves
}


def call_site(default: str, depth: int = 2) -> str:
    """The NODE_CALL_SITES name of the nearest listed function on the
    caller's stack, else `default`."""
    frame = sys._getframe(depth)
    while frame is not None:
        named = NODE_CALL_SITES.get(frame.f_code.co_name)
        if named is not None:
            return named
        frame = frame.f_back
    return default


class node_verify_log(verify_log):
    """verify_log around the node's own Verifier, whose callers are not
    tagged: a dispatch is named by where it runs: the gate's thread
    ("gate"), the signed kvstore's deliver_txs ("deliver"), the restart's
    reconstruct_last_commit ("seen_commit"), a vote micro-batch ("vote"),
    an aggregate LastCommit ("aggregate"), else a full LastCommit
    ("commit")."""

    def _note(self, source: str, lanes: int) -> None:
        if source == "commit":
            source = "gate" if threading.current_thread().name == NODE_GATE_THREAD else call_site("commit")
        super()._note(source, lanes)


class node_hash_log:
    """The node's Hasher with every part_leaf_hashes batch recorded as
    (source, leaves): "snapshot" for the snapshot producer's chunk digests,
    "tree" for a state-tree wave, "parts" for a part set under the size
    gate (PartSet.from_data's host leaves), else "other". The method is
    wrapped on the instance, so the node's wiring (the app's tree, the
    producer, the consensus state's part hasher) calls it as before."""

    def __init__(self, hasher):
        self.calls: list[tuple[str, int]] = []
        self._mtx = threading.Lock()
        leaf_hashes = hasher.part_leaf_hashes

        def logged(chunks):
            source = call_site("other")
            with self._mtx:
                self.calls.append((source, len(chunks)))
            return leaf_hashes(chunks)

        hasher.part_leaf_hashes = logged

    def take(self) -> list[tuple[str, int]]:
        with self._mtx:
            out, self.calls = self.calls, []
        return out


class rpc_feeder:
    """A wallet gateway in front of the node: a pool of NODE_RPC_CLIENTS
    threads, each on its own keep-alive connection (HTTPClient keeps one a
    thread), sends a burst by broadcast_tx_sync and keeps every answer. The
    connections open one at a time before the first burst, as a gateway's
    pool fills (64 at once overflow the RPC listener's backlog of 5)."""

    def __init__(self, addr: str):
        from concurrent.futures import ThreadPoolExecutor

        from tendermint_tpu_torch.rpc.client import HTTPClient

        self.client = HTTPClient(addr, timeout=60.0)
        self.pool = ThreadPoolExecutor(NODE_RPC_CLIENTS, thread_name_prefix="wallet")
        self.bursts: list[dict] = []
        self._on_every_worker(self.client.status)

    def _on_every_worker(self, fn) -> None:
        """fn once on each of the pool's threads, one call at a time: each
        call holds its thread until all have run, so no thread takes two."""
        turn, all_in = threading.Lock(), threading.Barrier(NODE_RPC_CLIENTS)

        def once() -> None:
            try:
                with turn:
                    fn()
            finally:
                all_in.wait(timeout=NODE_WAIT_S)

        for f in [self.pool.submit(once) for _ in range(NODE_RPC_CLIENTS)]:
            f.result()

    def send(self, txs: list[bytes]) -> tuple[dict[int, dict], list]:
        from tendermint_tpu_torch.rpc.client import RPCClientError

        def one(tx: bytes):
            try:
                return self.client.broadcast_tx_sync(tx=tx.hex()), None
            except (RPCClientError, OSError) as exc:
                return None, f"{type(exc).__name__}: {exc}"

        reconnects = self.client.reconnects
        t0 = time.perf_counter()
        results = list(self.pool.map(one, txs))
        seconds = time.perf_counter() - t0
        answers = {i: a for i, (a, err) in enumerate(results) if err is None}
        errors = [(i, err) for i, (_a, err) in enumerate(results) if err is not None]
        self.bursts.append({"txs": len(txs), "seconds": seconds, "txs_per_s": len(txs) / seconds,
                            "refused": sum(1 for a in answers.values() if a["code"]), "errors": len(errors),
                            "reconnects": self.client.reconnects - reconnects})
        return answers, errors

    def close(self) -> None:
        self._on_every_worker(self.client.close)
        self.pool.shutdown()


class node_adapter:
    """committee_pump's view of a started port Node: its consensus state,
    genesis, priv validator, block store and mempool, and `feed`, which
    sends a burst over the node's own RPC (rpc_feeder) and waits until the
    pool holds the accepted txs. The pump's start of the consensus state
    finds it started (node.start() did, through the consensus reactor)."""

    def __init__(self, p, node):
        self.p, self.node = p, node
        self.cs, self.doc, self.pv = node.consensus_state, node.genesis_doc, node.priv_validator
        self.store, self.mempool = node.block_store, node.mempool
        self.started = True
        self.feeder = rpc_feeder(f"127.0.0.1:{node.rpc_port()}")

    def feed(self, txs: list[bytes], timeout: float = EXEC_DRAIN_S) -> list[int]:
        before = self.mempool.size()
        answers, errors = self.feeder.send(txs)
        if errors or len(answers) != len(txs):
            raise AssertionError(f"RPC ingest: {len(errors)} of {len(txs)} txs shed or unanswered: {errors[:3]}")
        refused = sorted(i for i, a in answers.items() if a["code"])
        wait_for(lambda: self.mempool.size() >= before + len(txs) - len(refused), timeout,
                 "the burst's accepted txs in the pool")
        return refused

    def close(self) -> None:
        self.feeder.close()


def _get_json(port: int, path: str) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode() or "{}")


def node_rpc_reads(node, first: int, last: int) -> dict:
    """What the node's own HTTP surface says after a session, each read
    held against the node: /status at the last height, /health ok,
    /block and /commit of each height of the session equal to the store's
    bytes, GET /metrics' gateway_verify_* and gateway_hash_* equal to the
    Verifier's and the Hasher's stats() (read before and after the
    scrape, unchanged) with device counters above 0, a sampled tx's
    /tx_trace stages, the session's /consensus_trace and /debug/flight's
    refused votes and exceptions."""
    import urllib.request

    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.types.block import Block

    port = node.rpc_port()
    client = HTTPClient(f"127.0.0.1:{port}")
    store = node.block_store
    status = client.status()
    if status["latest_block_height"] != last:
        raise AssertionError(f"/status: height {status['latest_block_height']}, expected {last}")
    code, health = _get_json(port, "/health")
    if code != 200 or health.get("status") != "ok":
        raise AssertionError(f"/health: {code} {health}")
    for h in range(first, last + 1):
        got = client.block(height=h)
        if Block.from_json(got["block"]).to_bytes() != store.load_block(h).to_bytes() or \
                got["block_meta"] != json.loads(json.dumps(store.load_block_meta(h).to_json())):
            raise AssertionError(f"/block at {h} differs from the store")
        got = client.commit(height=h)
        want = store.load_seen_commit(h) if h == last else store.load_block_commit(h)
        if got["commit"] != json.loads(json.dumps(want.to_json())) or \
                got["header"] != json.loads(json.dumps(store.load_block_meta(h).header.to_json())):
            raise AssertionError(f"/commit at {h} differs from the store")
    before = (node.verifier.stats(), node.hasher.stats())
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
        body = resp.read().decode()
    after = (node.verifier.stats(), node.hasher.stats())
    if before != after:
        raise AssertionError("the gateway's stats moved during the scrape")
    scraped = {}
    for line in body.splitlines():
        if line.startswith(("gateway_verify_", "gateway_hash_")) and " " in line:
            key, value = line.rsplit(" ", 1)
            scraped[key] = float(value)
    for prefix, stats in (("gateway_verify", before[0]), ("gateway_hash", before[1])):
        for k, v in stats.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool) and scraped.get(f"{prefix}_{k}") != float(v):
                raise AssertionError(f"/metrics {prefix}_{k} {scraped.get(f'{prefix}_{k}')} != stats() {v}")
    device = {k: before[0][k] for k in ("tpu_batches", "tpu_sigs", "agg_batches", "agg_lanes_device")}
    device.update({k: before[1][k] for k in ("tpu_part_batches", "tpu_tx_roots", "tpu_leaves")})
    if not all(v > 0 for v in device.values()):
        raise AssertionError(f"/metrics shows no device work: {device}")
    traced = [t for t in client.tx_trace(last=256)["traces"] if t["outcome"] == "committed"]
    if not traced:
        raise AssertionError("/tx_trace: no committed trace")
    sample = client.tx_trace(hash=traced[0]["hash"])["traces"]
    stages = set(sample[0]["stages"]) if sample else set()
    if not {"rpc_ingress", "sig_gate", "mempool_admit", "block_commit"} <= stages:
        raise AssertionError(f"/tx_trace {traced[0]['hash']}: stages {sorted(stages)}")
    traces = client.consensus_trace(last=last - first + 1)["traces"]
    _, flight = _get_json(port, "/debug/flight")
    rejects = [(e["height"], e["type"], e["err"].split(":")[0]) for e in flight["events"] if e["kind"] == "vote_reject"]
    exceptions = [e for e in flight["events"] if e["kind"] == "exception"]
    return {"status_height": status["latest_block_height"], "health": health["status"], "metrics_device": device,
            "tx_trace": {"hash": traced[0]["hash"], "stages": sample[0]["stages"], "spans": sample[0]["spans"]},
            "traces": sorted(traces, key=lambda t: t["height"]), "rejects": rejects, "exceptions": exceptions}


def node_session(setup, vlog, hlog, root: str, first: int, last: int, restarted: bool, on_started=None) -> dict:
    """One session of the port Node in `root`: built by default_new_node
    from the home's config (on a home that holds a chain: the Handshaker's
    replay, the WAL, the seen commit primed), started, pumped through
    heights first..last by committee_pump over node_adapter, its launches
    read once the session's snapshots are on disk, its RPC read, stopped.
    The block times are pinned through the consensus state's
    propose_time_source seam, as phase 31's node pins them."""
    from tendermint_tpu_torch.config.toml import load_config
    from tendermint_tpu_torch.node import default_new_node
    from tendermint_tpu_torch.types.tx import tx_hash

    verifier = vlog.verifier
    gc.collect()
    reset_launches()
    t0 = time.perf_counter()
    node = default_new_node(load_config(root))
    build_s = time.perf_counter() - t0
    if node.verifier is not verifier:
        raise AssertionError("the node did not take the gateway's default Verifier")
    node.consensus_state.propose_time_source = lambda h: BLOCK_TIME_NS + h * 10**9
    node.start()
    adapter = None
    try:
        if on_started is not None:
            on_started(node)
        adapter = node_adapter(setup.p, node)
        out = committee_pump(adapter, setup.keys, setup.bursts, first, last, forged_height=NODE_FORGED_HEIGHT,
                             restarted=restarted, wait_s=NODE_WAIT_S)
        snaps = {h for h in range(first, last + 1) if h % NODE_SNAPSHOT_INTERVAL == 0}
        wait_for(lambda: snaps <= set(node.snapshot_store.heights()), NODE_WAIT_S, "the session's snapshots")
        if DEVICE != "cpu":
            _sync()
        launches = read_launches()
        calls, hash_calls = vlog.take(), hlog.take()
        store = node.block_store
        records = []
        for h in range(1, last + 1):
            meta, block = store.load_block_meta(h), store.load_block(h)
            records.append({"height": h, "parts_total": meta.block_id.parts_header.total,
                            "block": block.to_bytes(), "txs": list(block.data.txs)})
        round_zero = all(all(v is None or v.round_ == 0 for v in store.load_seen_commit(h).precommits)
                         for h in range(first, last + 1))
        rpc = node_rpc_reads(node, first, last)
        index = [[node.tx_indexer.get(tx_hash(tx)).to_json() for tx in r["txs"][:NODE_INDEX_SAMPLE]]
                 for r in records]
        ingest = list(adapter.feeder.bursts)
        device_error = node.consensus_state.device_error
        gate = {"fail_open": node.mempool.sig_batcher.fail_open, "device_error": node.mempool.sig_batcher.device_error}
    finally:
        if adapter is not None:
            adapter.close()
        node.stop()
    if device_error is not None or gate["device_error"] is not None or gate["fail_open"] or rpc["exceptions"]:
        raise AssertionError(f"node stopped: {device_error} {gate} {rpc['exceptions']}")
    return {"out": out, "launches": launches, "calls": calls, "hash_calls": hash_calls, "records": records,
            "round_zero": round_zero, "rpc": rpc, "index": index, "ingest": ingest, "build_s": build_s,
            "gate": gate, "verifier": verifier.stats(), "hasher": node.hasher.stats()}


def node_expected(run: dict, setup, first: int, last: int, gate: int, hash_gate: int, restarted: bool) -> dict:
    """The dispatches and launches one session implies, from the code's call
    sites (consensus/state.py, state/execution.py, the signed kvstore,
    statesync/producer.py, statetree/tree.py), as committee_expected counts
    them: four LastCommit checks a height from 2 (prevote, lock, finalize,
    apply), "commit" (B1) for a full one, "aggregate" (dsm, n + 1 lanes)
    from the upgrade; one deliver a height applied and, on a restart, one a
    block the Handshaker replays, and the seen commit primed; the gate's
    batches and the vote micro-batches as recorded (both batch by time).
    A dispatch of `gate` lanes or more is one launch. K1 and K3: one each
    a height's tx root and a part set of the node's own proposals of
    `hash_gate` parts or more; K1 once more a state-tree wave (a replayed
    block's too: the node hands the tree its Hasher before the handshake)
    or a snapshot's chunk digests (one a height on the interval) of
    `hash_gate` leaves or more."""
    doc = setup.doc
    calls = run["calls"]
    heights = range(first, last + 1)
    full = sum(h >= 2 and not doc.aggregate_commits_at(h) for h in heights)
    agg = sum(doc.aggregate_commits_at(h) for h in heights)
    replayed = first - 1 if restarted else 0
    want = {"commit": 4 * full, "deliver": len(heights) + replayed, "aggregate": 4 * agg,
            "seen_commit": 1 if restarted else 0}
    got: dict[str, int] = {}
    for src, _n in calls:
        got[src] = got.get(src, 0) + 1
    if {k: got.get(k, 0) for k in want} != want or set(got) - set(want) - {"vote", "gate", "one"}:
        raise AssertionError(f"dispatches by source {got}, expected {want} and vote, gate, one")
    fixed = [(src, n) for src, n in calls if src in want]
    if any(n < gate for _src, n in fixed):
        raise AssertionError(f"a LastCommit, deliver or seen commit under the size gate: {fixed}")
    snaps = [src for src, _n in run["hash_calls"] if src == "snapshot"]
    want_snaps = sum(h % NODE_SNAPSHOT_INTERVAL == 0 for h in heights)
    if len(snaps) != want_snaps or any(src == "other" for src, _n in run["hash_calls"]):
        raise AssertionError(f"hash calls {run['hash_calls']}: expected {want_snaps} snapshot digest batches")
    parts = {r["height"]: r["parts_total"] for r in run["records"]}
    own = sum(h in setup.own_heights and parts[h] >= hash_gate for h in heights)
    own_host_parts = sum(parts[h] for h in heights if h in setup.own_heights and parts[h] < hash_gate)
    leaves = [(src, n) for src, n in run["hash_calls"] if src != "parts"]  # own part sets are counted above
    leaf_batches = sum(n >= hash_gate for _src, n in leaves)
    snap_device = sum(n >= hash_gate for src, n in leaves if src == "snapshot")
    b1 = sum(1 for src, n in calls if n >= gate and src != "aggregate")
    return {"b1": b1, "dsm": 4 * agg, "ripemd160": len(heights) + own + leaf_batches,
            "merkle_tree": len(heights) + own, "sources": want, "recorded": got, "own_proposals": own,
            "own_host_parts": own_host_parts, "leaf_batches_device": leaf_batches,
            "snapshots_device": snap_device,
            "host_leaves": own_host_parts + sum(n for _src, n in leaves if n < hash_gate),
            "b1_fixed": sum(want.values()) - 4 * agg,
            "gate_lanes": [n for src, n in calls if src == "gate"],
            "vote_lanes": [n for src, n in calls if src == "vote"]}


def node_phase(name, power, seeds, bursts) -> dict:
    """Phase 37: the node_validator cell on the card. One port Node, built
    by default_new_node from a home written as an operator's (node_home),
    takes the gateway's defaults (the card's Verifier and Hasher; no daemon
    serves), and commits heights 1..NODE_HEIGHTS under committee_pump with
    the other 99 keys as its stubs; each burst reaches it over its own
    HTTP JSON-RPC broadcast_tx_sync from NODE_RPC_CLIENTS client threads;
    one stub's precommit at NODE_FORGED_HEIGHT is forged. The node stops; a
    second Node from the same home (the Handshaker's replay, the WAL)
    commits the rest. A host replay of the node's stored chain
    (gossip_reference, a process of its own beside the card) gives every
    saved state, app hash and tx-index sample the node's; every valid tx
    is in exactly one block and only the forged ones were refused, at every
    height; only the forged precommit was refused; the node's HTTP answers
    hold (node_rpc_reads); each session's launches, set to 0 before its
    node is built and read after its pump and snapshots, equal
    node_expected's, and the lanes and the Hasher's stats agree. Returns
    what phase 38 needs and the launches."""
    from tendermint_tpu_torch.libs.db import db_provider
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.types import tx as ptx

    tag = {"card": name, "power_limit": power}
    setup = node_setup(seeds, bursts)
    n = len(setup.keys)
    total = setup.own_power + n - 1
    log({"phase": "node_setup", **tag, "validators": n, "node_power": setup.own_power, "total_power": total,
         "node_proposes_at": setup.own_heights, "upgrade_height": NODE_UPGRADE_HEIGHT, "heights": NODE_HEIGHTS,
         "restart_heights": NODE_RESTART_HEIGHTS, "txs_per_height": [len(b["txs"]) for b in bursts],
         "forged_precommit_height": NODE_FORGED_HEIGHT, "rpc_clients": NODE_RPC_CLIENTS,
         "snapshot_interval": NODE_SNAPSHOT_INTERVAL, "timeout_commit_s": NODE_TIMEOUT_COMMIT})
    saved = gateway._default_verifier, gateway._default_hasher
    root = tempfile.mkdtemp(prefix="node-validator-")
    reference = multiprocessing.get_context("spawn").Pool(1)
    pending = {}
    t_phase = time.perf_counter()
    try:
        with routed_to():
            gateway._default_verifier = gateway._default_hasher = None
            verifier, hasher = gateway.default_verifier(), gateway.default_hasher()
            if verifier.kernel != "f32p" or hasher._route != "local":
                raise AssertionError(f"the node's routes: {verifier.kernel}, {hasher._route}")
            vlog, hlog = node_verify_log(verifier), node_hash_log(hasher)
            db_dir = node_home(setup, root)

            def start_reference(_node) -> None:
                # the host replay follows the node's store from now on
                pending["ref"] = reference.apply_async(gossip_reference, (db_dir, setup.doc.to_json(), setup.last,
                                                                          NODE_INDEX_SAMPLE, 10 * NODE_WAIT_S))

            sessions = ((1, NODE_HEIGHTS, False), (NODE_HEIGHTS + 1, setup.last, True))
            runs = []
            for a, b, restarted in sessions:
                runs.append(node_session(setup, vlog, hlog, root, a, b, restarted,
                                         on_started=None if restarted else start_reference))
            db = db_provider("state", "sqlite", db_dir)
            try:
                final_state = State.load_state(db, setup.doc).bytes_()
            finally:
                db.close()
            t_ref = time.perf_counter()
            ref = pending["ref"].get(timeout=10 * NODE_WAIT_S)
            ref_wait_s = time.perf_counter() - t_ref
    finally:
        reference.terminate()
        reference.join()
        ptx.set_batch_tx_root(None)
        gateway._default_verifier, gateway._default_hasher = saved
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase

    # -- the checks ----------------------------------------------------------
    gate, hash_gate = verifier.min_tpu_batch, hasher.min_tpu_batch
    last = setup.last
    states = {**runs[0]["out"]["states"], **runs[1]["out"]["states"]}
    if runs[1]["out"]["states"][NODE_HEIGHTS] != runs[0]["out"]["states"][NODE_HEIGHTS]:
        raise AssertionError("the restarted node's state differs from the stopped node's")
    node_states = [states[h] for h in range(1, last + 1)]
    if node_states != ref["states"][-last:] or final_state != ref["states"][-1]:
        raise AssertionError(f"saved states differ from the host reference's ({len(ref['states'])})")
    if runs[1]["index"] != ref["index"]:
        raise AssertionError("the tx-index samples differ from the host reference's")
    if not all(r["parts"] and r["data_hash"] for r in ref["roots"]):
        raise AssertionError(f"a block's part-set root or tx root differs on the host: {ref['roots']}")
    if any(ref["launches"].values()):
        raise AssertionError(f"the host reference launched kernels: {ref['launches']}")
    records = runs[1]["records"]
    if [r["block"] for r in runs[0]["records"]] != [r["block"] for r in records[:NODE_HEIGHTS]]:
        raise AssertionError("the restarted node's store differs from the stopped node's")
    committed: dict[bytes, int] = {}
    for r in records:
        for tx in r["txs"]:
            committed[tx] = committed.get(tx, 0) + 1
    valid = {tx for b in bursts for i, tx in enumerate(b["txs"]) if i not in set(b["forged"])}
    if set(committed) != valid or any(c != 1 for c in committed.values()):
        raise AssertionError(f"{len(set(committed) - valid)} txs committed outside the bursts' valid ones, "
                             f"{len(valid - set(committed))} valid ones not, "
                             f"{sum(c > 1 for c in committed.values())} more than once")
    own_burst = [len(r["txs"]) == len(bursts[r["height"] - 1]["txs"]) - len(bursts[r["height"] - 1]["forged"])
                 for r in records]
    refused = {**runs[0]["out"]["refused"], **runs[1]["out"]["refused"]}
    if sorted(refused) != list(range(1, last + 1)) or any(refused[h] != bursts[h - 1]["forged"] for h in refused):
        raise AssertionError(f"the gate refused other txs than the forged ones: {refused}")
    rejects = [runs[0]["rpc"]["rejects"], runs[1]["rpc"]["rejects"]]
    if rejects != [[(NODE_FORGED_HEIGHT, 2, "InvalidSignatureError")], []]:
        raise AssertionError(f"refused votes {rejects}: expected the forged precommit alone")
    if runs[0]["out"]["forged"] is None or not all(r["round_zero"] for r in runs):
        raise AssertionError("the forged precommit was not sent, or a height committed after round 0")
    launches, exps = {}, []
    for i, ((a, b, restarted), run) in enumerate(zip(sessions, runs)):
        label = f"node session {i + 1}"
        exp = node_expected(run, setup, a, b, gate, hash_gate, restarted)
        exps.append(exp)
        _launch_delta(run["launches"], {k: exp[k] for k in ("b1", "dsm", "ripemd160", "merkle_tree")}, label)
        for k in ("b1", "dsm", "ripemd160", "merkle_tree"):
            launches[k] = launches.get(k, 0) + run["launches"][k]
        log({"phase": "node_path", **tag, "session": i + 1, "heights": [a, b], "restarted": restarted,
             "launches": run["launches"], "sources": exp["sources"], "recorded": exp["recorded"],
             "gate_batches": len(exp["gate_lanes"]), "gate_lanes": sum(exp["gate_lanes"]),
             "gate_lanes_host": sum(x for x in exp["gate_lanes"] if x < gate),
             "vote_batches": len(exp["vote_lanes"]), "hash_calls": run["hash_calls"],
             "snapshots_device": exp["snapshots_device"], "build_s": run["build_s"],
             "wall_s": run["out"]["wall_s"], "ingest": run["ingest"], "rpc": {k: run["rpc"][k] for k in (
                 "status_height", "health", "metrics_device", "tx_trace")}})
    # the lanes: the verifier's and the Hasher's stats over the whole phase
    all_calls = runs[0]["calls"] + runs[1]["calls"]
    # (cpu_sigs is not held: a lone verify_one of a primed vote pops its lane)
    lanes = {"tpu_sigs": sum(n for src, n in all_calls if n >= gate and src != "aggregate"),
             "agg_lanes_device": sum(n for src, n in all_calls if n >= gate and src == "aggregate"),
             "agg_lanes_cpu": sum(n for src, n in all_calls if n < gate and src == "aggregate")}
    vstats = runs[1]["verifier"]
    if {k: vstats[k] for k in lanes} != lanes:
        raise AssertionError(f"verifier lanes { {k: vstats[k] for k in lanes} }, expected {lanes}")
    hs = runs[1]["hasher"]
    want_hash = {"tpu_tx_roots": last, "tpu_part_batches": sum(e["own_proposals"] + e["leaf_batches_device"]
                                                               for e in exps),
                 "cpu_leaves": sum(e["host_leaves"] for e in exps)}
    if {k: hs[k] for k in want_hash} != want_hash:
        raise AssertionError(f"hasher { {k: hs[k] for k in want_hash} }, expected {want_hash}")
    log({"phase": "node_plane", **tag, "validators": n, "heights": last, "launches": launches, "lanes": lanes,
         "hasher": {k: hs[k] for k in ("tpu_part_batches", "tpu_tx_roots", "tpu_leaves", "cpu_leaves")},
         "forged_precommit": runs[0]["out"]["forged"], "burst_in_its_height": own_burst,
         "phase_s": phase_s, "reference_wait_s": ref_wait_s,
         "records": "equal to the host replay; /block and /commit equal to the store"})
    return {"setup": setup, "runs": runs, "ref": ref, "launches": launches, "gate": gate, "exps": exps,
            "phase_s": phase_s, "ref_wait_s": ref_wait_s}


def node_time(name, power, ctx) -> None:
    """Phase 38: phase 37's run as its operator reads it, through the node's
    RPC and its stats(): each height's wall and /consensus_trace segments;
    the RPC ingest rate of each burst (txs/s from the first send to the
    last answer); the gate's batches, their widths and the share of gate
    lanes that fell under the size gate to the native CPU floor; the
    restart's build seconds (default_new_node: the handshake's replay of
    the stored blocks into a fresh app); the host replay's seconds and the
    phase's own."""
    tag = {"card": name, "power_limit": power}
    gate = ctx["gate"]
    for i, run in enumerate(ctx["runs"]):
        heights = [{"height": t["height"], "wall_s": t["wall_s"], "segments": t["segments"]}
                   for t in run["rpc"]["traces"]]
        exp = ctx["exps"][i]
        gate_lanes = exp["gate_lanes"]
        log({"phase": "node_time", **tag, "session": i + 1, "wall_s": run["out"]["wall_s"],
             "blocks_per_sec": len(heights) / run["out"]["wall_s"], "pump_sign_s": run["out"]["sign_s"],
             "per_height": heights, "build_s": run["build_s"],
             "ingest_txs_per_s": [b["txs_per_s"] for b in run["ingest"]],
             "ingest_s": [b["seconds"] for b in run["ingest"]],
             "gate_batches": len(gate_lanes), "gate_widths": sorted(gate_lanes),
             "gate_host_share": sum(x for x in gate_lanes if x < gate) / max(1, sum(gate_lanes)),
             "vote_batches": len(exp["vote_lanes"])})
    log({"phase": "node_time", **tag, "restart_build_s": ctx["runs"][1]["build_s"],
         "reference_replay_s": ctx["ref"]["seconds"], "reference_wait_s": ctx["ref_wait_s"],
         "phase_37_s": ctx["phase_s"]})


# -- phases 39-40: the localnet, port node processes started by the CLI ----------


def make_localnet_inputs(pool, rng) -> list[dict]:
    """Phase 39's bursts, from their own generator so the earlier phases'
    draws stay as they were: LOCALNET_BURSTS of phase 37's families."""
    return make_bursts(pool, rng, LOCALNET_BURSTS, COMMITTEE_FIRST_BLOCK, COMMITTEE_BLOCK,
                       COMMITTEE_VALUE_BYTES, EXEC_SIGNERS, b"lnet-%07d")


def localnet_homes(spec) -> None:
    """Generous liveness timeouts in every generated home (the fleet's
    start window, each height's commit window and the burst's ingest stay
    the spec's timeout_commit): no height of the run changes round while a
    process is still starting or a 1 MB proposal is in flight."""
    from tendermint_tpu_torch.config.toml import config_to_toml, load_config

    for i in range(spec.n):
        cfg = load_config(spec.home(i))
        cc = cfg.consensus
        cc.timeout_propose = LOCALNET_TIMEOUT_PROPOSE
        cc.timeout_prevote = cc.timeout_precommit = LOCALNET_TIMEOUT_VOTE
        if cfg.statesync.snapshot_interval:
            raise AssertionError("a generated home takes snapshots: their digests are not in localnet_expected")
        with open(os.path.join(spec.home(i), "config.toml"), "w") as f:
            f.write(config_to_toml(cfg))


def localnet_scrape(net) -> list[dict]:
    """Each member's device work, read as an operator reads it: ops/fleet's
    scrape of its GET /metrics (the gateway's Verifier and Hasher counters,
    the gate's batch count)."""
    from tendermint_tpu_torch.ops import fleet

    names = {"tpu_batches": "gateway_verify_tpu_batches", "tpu_sigs": "gateway_verify_tpu_sigs",
             "cpu_sigs": "gateway_verify_cpu_sigs", "agg_batches": "gateway_verify_agg_batches",
             "agg_lanes_device": "gateway_verify_agg_lanes_device", "agg_lanes_cpu": "gateway_verify_agg_lanes_cpu",
             "tpu_tx_roots": "gateway_hash_tpu_tx_roots", "tpu_part_batches": "gateway_hash_tpu_part_batches",
             "tpu_leaves": "gateway_hash_tpu_leaves", "cpu_leaves": "gateway_hash_cpu_leaves",
             "gate_batches": "mempool_sig_gate_batch_seconds_count", "height": "consensus_height"}
    out = []
    for node in net.nodes:
        m = fleet.fetch_metrics(node.rpc_url)
        row = {k: fleet.metric_value(m, name) for k, name in names.items()}
        if any(v is None for v in row.values()):
            raise AssertionError(f"node{node.index}'s /metrics lacks {[k for k, v in row.items() if v is None]}")
        out.append({k: int(v) for k, v in row.items()})
    return out


def logged_launches(path: str) -> dict[str, int]:
    """A port process's kernel launches, from the `kernel launches {...}`
    line its CLI prints once stopped (cli.report_launches): its wrappers'
    counts, from 0 at the process's start."""
    with open(path, "rb") as f:
        got = last_launch_line(f.read().decode(errors="replace"))
    if got is None:
        raise AssertionError(f"{path} holds no kernel launches line")
    return got


def localnet_expected(chain: dict, scraped: list[dict], launched: list[dict], ref_waves: dict, proposers: dict,
                      gate: int, hash_gate: int, burst_lanes: list[int]) -> list[dict]:
    """Each member's kernel launches (`launched`: logged by its CLI at its
    exit) held against its gateway counters (`scraped`, read just before
    the stop) and against a prediction from the chain (read over node 0's
    RPC) and the host replay's tree waves, from the code's call sites:
    - B1: a launch a device batch of the Verifier (tpu_batches): one
      deliver a block of `gate` txs or more (the signed kvstore's
      deliver_txs, every member), and the gate's batches of `gate` lanes or
      more. The gate's batches are bounded, not predicted: a batch's width
      follows the arrival of the txs (the RPC clients' pace at node 0, the
      mempool reactor's at the others), which no scrape shows. So the
      gate's device lanes are at most the lanes its gate saw (the burst's
      at node 0, the valid ones relayed at the others), at least 32 and at
      most 512 (SigBatcher's max_batch) a batch, its device batches at most
      the gate's batches; node 0's gate puts lanes on B1.
    - dsm: none; a 4-validator commit (4 lanes, 5 an aggregate) stays under
      the gate on the host, every check of it (agg_lanes_cpu above 0).
    - K1: a launch a block's tx root of `hash_gate` txs or more, on every
      member; a part set of the member's own proposals of `hash_gate`
      parts or more; a state-tree wave that reaches the Hasher (32 nodes or
      more; the host replay's widths).
    - K3: a launch a tx root and an own part set of those (a wave's
      parents are built on the host).
    - b2, comb, tables, sha256: none."""
    txs = {h: len(t) for h, t in chain["txs"].items()}
    parts = chain["parts"]
    delivers = [txs[h] for h in sorted(txs) if txs[h] >= gate]
    roots = [txs[h] for h in sorted(txs) if txs[h] >= hash_gate]
    waves = [w for h in sorted(ref_waves) if h <= chain["height"] for w in ref_waves[h] if w >= hash_gate]
    out = []
    for i, (got, ran) in enumerate(zip(scraped, launched)):
        own = [parts[h] for h in sorted(parts) if proposers[h] == i and parts[h] >= hash_gate]
        exp = {"tpu_tx_roots": len(roots), "tpu_part_batches": len(own) + len(waves),
               "tpu_leaves": sum(roots) + sum(own) + sum(waves), "agg_batches": 0, "agg_lanes_device": 0}
        if {k: got[k] for k in exp} != exp:
            raise AssertionError(f"node{i}'s scraped hash and aggregate counters { {k: got[k] for k in exp} }, "
                                 f"expected {exp}")
        want = {"b1": got["tpu_batches"], "b2": 0, "dsm": 0, "comb": 0, "tables": 0,
                "ripemd160": len(roots) + len(own) + len(waves), "sha256": 0, "merkle_tree": len(roots) + len(own)}
        if ran != want:
            raise AssertionError(f"node{i}'s kernel launches {ran}, expected {want} (B1 its {got['tpu_batches']} "
                                 f"device batches; K1 and K3 {len(roots)} tx roots, {len(own)} own part sets, "
                                 f"{len(waves)} waves)")
        gate_lanes = got["tpu_sigs"] - sum(delivers)
        gate_batches = got["tpu_batches"] - len(delivers)
        seen = burst_lanes[0] if i == 0 else burst_lanes[1]
        if not (0 <= gate_lanes <= seen and 32 * gate_batches <= gate_lanes <= 512 * gate_batches
                and gate_batches <= got["gate_batches"]):
            raise AssertionError(f"node{i}'s gate on B1: {gate_batches} batches, {gate_lanes} lanes, of "
                                 f"{got['gate_batches']} gate batches and {seen} lanes")
        if (i == 0 and gate_lanes == 0) or got["agg_lanes_cpu"] == 0 or got["cpu_sigs"] == 0:
            raise AssertionError(f"node{i}: no gate lanes on B1, or no commit lane on the host: {got}")
        out.append({**exp, "deliver_batches": len(delivers), "deliver_lanes": sum(delivers),
                    "gate_batches_device": gate_batches, "gate_lanes_device": gate_lanes, "gate_lanes": seen,
                    "own_part_sets": len(own), "waves": len(waves), "launches": ran})
    return out


def localnet_proposers(doc, rounds: dict[int, int]) -> dict[int, bytes]:
    """The address that proposed each height's block: the genesis set's
    rotation, advanced once a height as State advances it, and `rounds[h]`
    more times at height h for the round it committed in, as consensus
    advances a copy of the set (consensus/state.py, enter_new_round)."""
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.state.state import State

    vals = State.get_state(MemDB(), doc).validators
    out = {}
    for h in range(1, max(rounds) + 1):
        at = vals.copy()
        if rounds[h]:
            at.increment_accum(rounds[h])
        out[h] = at.get_proposer().address
        vals = vals.copy()
        vals.increment_accum(1)
    return out


def localnet_chain(client, last: int) -> dict:
    """Node 0's chain over its RPC: each height's txs, part count, commit
    round and app hash."""
    from tendermint_tpu_torch.types.agg_commit import commit_from_json

    out = {"height": last, "txs": {}, "parts": {}, "round": {}, "app_hash": {}, "fingerprint": {}}
    for h in range(1, last + 1):
        res = client.block(height=h)
        meta, block = res["block_meta"], res["block"]
        out["txs"][h] = [bytes.fromhex(t) for t in (block["data"]["txs"] or [])]
        out["parts"][h] = meta["block_id"]["parts"]["total"]
        out["app_hash"][h] = block["header"]["app_hash"]
        out["round"][h] = commit_from_json(client.commit(height=h)["commit"]).round_()
    return out


def startup_probe() -> dict:
    """Where a port process's start goes, in this fresh process: the torch
    import, the port's node package, the CUDA context, the libraries'
    load and B1's first launch (its module load) and second, each in
    seconds."""
    import importlib

    t = time.perf_counter()
    out = {}
    import torch

    out["torch_import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    importlib.import_module("tendermint_tpu_torch.node")
    out["package_import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out["cuda_context_s"] = time.perf_counter() - t
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import kernels

    t = time.perf_counter()
    for name in ("ed25519_verify", "hash_blocks", "merkle_tree"):
        kernels.load(name)
    out["libraries_load_s"] = time.perf_counter() - t
    seed = bytes(range(32))
    items = [(ed.public_key(seed), b"probe", ed.sign(seed, b"probe"))] * 32
    for key in ("b1_first_launch_s", "b1_second_launch_s"):
        args, _, _ = f32p.marshal_device_args(items, "cuda")
        t = time.perf_counter()
        f32p.verify_lanes(*args)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t
    return out


def free_port_range(n: int) -> int:
    """A base port whose n ports on 127.0.0.1 are free now, below the
    ephemeral range (where the link proxies' own ports land): a fleet's
    p2p and RPC ports (tests/test_torch_localnet.py's fleets too)."""
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = np.random.default_rng()
    for _ in range(200):
        base = int(rng.integers(max(1024, low - 12000), max(2048, low - n - 1)))
        socks = []
        try:
            for port in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} free ports in a row")


def localnet_phase(name, power, bursts) -> dict:
    """Phase 39: the localnet cell on the card. The port's ops/localnet
    generates a LOCALNET_NODES-validator fleet (the signed kvstore behind
    the gate, sqlite, full topology through netfaults link proxies,
    aggregate commits from LOCALNET_UPGRADE_HEIGHT; localnet_homes' timeouts)
    and starts it: one `python -m tendermint_tpu_torch.cli node` process a
    member, each holding the card (no daemon, no host fallback). Each burst
    goes to node 0 over its HTTP JSON-RPC broadcast_tx_sync from
    NODE_RPC_CLIENTS threads in the window before a proposal: the first
    once every member's RPC answers (height 1's start window), each next
    one once the height before it commits. Checks: every height up to the fleet's
    least is byte-identical on the four (Localnet.assert_converged); every
    valid tx is in exactly one block, none else is, and only the forged
    txs were refused (the heights that hold each burst are logged: one,
    when the burst reached the proposer whole); each member's kernel
    launches, printed by its CLI as it stops, agree with its gateway
    counters scraped just before the stop and with the chain in
    localnet_expected (the proposers from each height's commit round; the
    gate's device batches bounded, not predicted), and the replica
    launches none; a `cli replica` process following
    node 0 serves LOCALNET_READ_KEYS present and as many absent keys at the
    last burst height equal to node 0's values, through a LightClient
    pointed at it; SIGTERM ends each process with exit 0; a host replay of
    node 0's stored chain (gossip_reference, a process of its own) gives
    node 0's last saved state and every app hash of its chain; and
    `cli --home <node 0> replay` exits 0 having replayed messages to node
    0's height or the one after. This process launches no kernel. Returns
    what phase 40 needs and the launches, summed over the five processes."""
    import signal

    from tendermint_tpu_torch.abci.apps.signedkv import parse_sig_tx
    from tendermint_tpu_torch.config.toml import load_config
    from tendermint_tpu_torch.libs.db import db_provider
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops import localnet as ln
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.rpc.light import LightClient
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    tag = {"card": name, "power_limit": power}
    gate = gateway._env_int("TENDERMINT_TPU_MIN_BATCH", 32)
    hash_gate = gateway._env_int("TENDERMINT_TPU_HASH_MIN_BATCH", 16)
    root = tempfile.mkdtemp(prefix="localnet-")
    spec = ln.LocalnetSpec(n=LOCALNET_NODES, root=root, chain_id="chip-localnet", seed=SEED, topology="full",
                           proxy_app="signedkv", db_backend="sqlite", upgrade_height=LOCALNET_UPGRADE_HEIGHT,
                           timeout_commit=LOCALNET_TIMEOUT_COMMIT, log_level="warning",
                           base_port=free_port_range(2 * LOCALNET_NODES + 1))
    net = ln.Localnet(spec).generate()
    localnet_homes(spec)
    doc = GenesisDoc.from_file(os.path.join(spec.home(0), "genesis.json"))
    log({"phase": "localnet_setup", **tag, "nodes": spec.n, "topology": spec.resolved_topology(),
         "links": len(spec.dial_edges()), "proxy_app": spec.proxy_app, "db_backend": spec.db_backend,
         "upgrade_height": spec.upgrade_height, "timeouts": {**spec.consensus_timeouts(),
                                                              "timeout_propose": LOCALNET_TIMEOUT_PROPOSE,
                                                              "timeout_prevote": LOCALNET_TIMEOUT_VOTE,
                                                              "timeout_precommit": LOCALNET_TIMEOUT_VOTE},
         "bursts": [len(b["txs"]) for b in bursts], "forged": [len(b["forged"]) for b in bursts],
         "rpc_clients": NODE_RPC_CLIENTS})
    addr_of = {}
    for i in range(spec.n):
        with open(os.path.join(spec.home(i), "priv_validator.json")) as f:
            addr_of[bytes.fromhex(json.load(f)["address"])] = i
    reset_launches()
    replica = feeder = None
    pool = multiprocessing.get_context("spawn").Pool(1)
    t_phase = time.perf_counter()
    try:
        t_start = time.perf_counter()
        net.start()
        starts = {i: {} for i in range(spec.n)}

        def started(key: str, height: int):
            def cond() -> bool:
                for node in net.nodes:
                    if not node.alive():
                        raise AssertionError(f"node{node.index} exited {node.proc.poll()}: "
                                             f"{open(os.path.join(node.home, 'node.log'), 'rb').read()[-800:]!r}")
                    st = starts[node.index]
                    if key not in st and node.height() >= height:
                        st[key] = time.perf_counter() - t_start
                return all(key in st for st in starts.values())
            return cond

        wait_for(started("rpc_up_s", 0), LOCALNET_WAIT_S, "every member's RPC")
        node0 = net.nodes[0]
        client = HTTPClient(node0.rpc_url, timeout=60.0)
        feeder = rpc_feeder(node0.rpc_url)
        replica = None
        # burst 1 is sent in height 1's start window, each next one once the
        # height before it commits: the commit window is its time to reach
        # node 0 and, relayed by the mempool reactor, the next proposer (sent
        # during a proposal, a burst slowed that proposal by seconds: the
        # processes share the host's cores)
        refused, targets = [], []
        for k, burst in enumerate(bursts):
            h0 = client.status()["latest_block_height"]
            targets.append(h0 + 1)
            answers, errors = feeder.send(burst["txs"])
            if errors or len(answers) != len(burst["txs"]):
                raise AssertionError(f"RPC ingest of burst {k + 1}: {len(errors)} errors: {errors[:3]}")
            refused.append(sorted(i for i, a in answers.items() if a["code"]))
            if k == 0:
                wait_for(started("first_height_s", 1), LOCALNET_WAIT_S, "every member's first height")
                # the replica follows node 0 from genesis, its start beside
                # the bursts
                replica = ln.ReplicaProc(os.path.join(root, "replica"), node0.rpc_url,
                                         spec.base_port + 2 * spec.n)
                replica.start()
                t_rep = time.perf_counter()
            wait_for(lambda: client.num_unconfirmed_txs()["n_txs"] == 0
                     and client.status()["latest_block_height"] > h0, LOCALNET_WAIT_S, f"burst {k + 1} committed")
        last_burst = client.status()["latest_block_height"]
        t_fed = time.perf_counter()
        # the last burst's state is read at last_burst, proven against
        # header last_burst + 1: every member and the replica past it
        wait_for(lambda: min(net.heights()) > last_burst, LOCALNET_WAIT_S, "every member past the last burst")
        upto = min(net.heights())
        converged = net.assert_converged(upto)
        chain = localnet_chain(client, upto)
        traces = [HTTPClient(node.rpc_url).consensus_trace(last=upto)["traces"] for node in net.nodes]
        wait_for(lambda: replica.lag() == 0 and replica.rpc("status")["latest_block_height"] > last_burst,
                 LOCALNET_WAIT_S, "the replica's walk past the last burst")
        replica_s = {"spawn_to_head": time.perf_counter() - t_rep, "after_last_burst": time.perf_counter() - t_fed}
        written = {}
        for b in bursts:
            bad = set(b["forged"])
            for i, tx in enumerate(b["txs"]):
                if i not in bad:
                    key, value = parse_sig_tx(tx)[1].split(b"=", 1)
                    written[key] = value
        keys = sorted(written)
        rng = np.random.default_rng(SEED + 39)
        present = [keys[i] for i in rng.choice(len(keys), size=LOCALNET_READ_KEYS, replace=False)]
        absent = [b"lnet-absent-%02d" % i for i in range(LOCALNET_READ_KEYS)]
        lc = LightClient.from_genesis(HTTPClient(replica.rpc_url, timeout=60.0))
        reads_ms = []
        for k in present + absent:
            q = client.abci_query(data=k.hex())["response"]
            at_node = bytes.fromhex(q["value"]) if q.get("value") else None
            t = time.perf_counter()
            r = lc.verified_query(k, height=last_burst)
            reads_ms.append(1e3 * (time.perf_counter() - t))
            want = written.get(k)
            if (r["value"], r["absent"], r["height"], at_node) != (want, want is None, last_burst, want):
                raise AssertionError(f"the replica's read of {k!r}: {r['value']!r} absent {r['absent']} at "
                                     f"{r['height']}; node 0 {at_node!r}, written {want!r}")
        # the gateway counters just before the stop, beside the launches
        # each process prints as it stops (cli.report_launches); every
        # process stops at once, and each must exit 0
        scraped = localnet_scrape(net)
        t_stop = time.perf_counter()
        procs = {"replica": replica.proc, **{node.index: node.proc for node in net.nodes}}
        for proc in procs.values():
            proc.send_signal(signal.SIGTERM)
        stopped = {k: proc.wait(timeout=60) for k, proc in procs.items()}
        stop_s = time.perf_counter() - t_stop
        replica.proc = None
        for node in net.nodes:
            node.proc = None
        launched = [logged_launches(os.path.join(node.home, "node.log")) for node in net.nodes]
        replica_launched = logged_launches(os.path.join(replica.home, "replica.log"))
        db_dir = load_config(spec.home(0)).base.db_dir()
        db = db_provider("state", "sqlite", db_dir)
        try:
            final_state = State.load_state(db, doc)
        finally:
            db.close()
        stored = final_state.last_block_height
        # the host replay, the `replay` command and phase 40's startup probe
        # side by side, each a process of its own
        pending = pool.apply_async(gossip_reference, (db_dir, doc.to_json(), stored, 0, 10 * LOCALNET_WAIT_S, True))
        t_replay = time.perf_counter()
        replay_proc = subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch.cli", "--home", spec.home(0),
                                        "replay"], env=ln.member_env(), cwd=REPO_DIR, text=True,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        probe_proc = subprocess.Popen([sys.executable, "-c", "import json, chip_smoke; "
                                       "print(json.dumps(chip_smoke.startup_probe()))"],
                                      env=ln.member_env(), cwd=REPO_DIR, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        replay_out, replay_err = replay_proc.communicate(timeout=10 * LOCALNET_WAIT_S)
        replay_s = time.perf_counter() - t_replay
        probe_out, probe_err = probe_proc.communicate(timeout=10 * LOCALNET_WAIT_S)
        if probe_proc.returncode != 0:
            raise AssertionError(f"the startup probe: {probe_err[-800:]}")
        probe = json.loads(probe_out.strip().splitlines()[-1])
        t_ref = time.perf_counter()
        ref = pending.get(timeout=10 * LOCALNET_WAIT_S)
        ref_wait_s = time.perf_counter() - t_ref
        own_launches = read_launches()
    except BaseException:
        # what each member said before it is stopped: the error's context
        for i in range(spec.n):
            with contextlib.suppress(OSError), open(os.path.join(spec.home(i), "node.log"), "rb") as f:
                log({"phase": "localnet_log", "node": i, "tail": f.read()[-3000:].decode(errors="replace")})
        with contextlib.suppress(Exception):
            log({"phase": "localnet_heights", "heights": net.heights(),
                 "mempools": [HTTPClient(n.rpc_url).num_unconfirmed_txs()["n_txs"] for n in net.nodes]})
        raise
    finally:
        if feeder is not None:
            feeder.close()
        if replica is not None:
            replica.kill()
        pool.terminate()
        pool.join()
        net.stop(keep_root=False)
    phase_s = time.perf_counter() - t_phase

    # -- the checks ----------------------------------------------------------
    if stopped != {"replica": 0, **{i: 0 for i in range(spec.n)}}:
        raise AssertionError(f"exit codes after SIGTERM: {stopped}")
    if any(own_launches.values()):
        raise AssertionError(f"this process launched kernels during the localnet: {own_launches}")
    committed: dict[bytes, int] = {}
    for h in range(1, upto + 1):
        for tx in chain["txs"][h]:
            committed[tx] = committed.get(tx, 0) + 1
    burst_heights = []  # the heights that hold each burst's valid txs: one, when it reached the proposer whole
    for k, b in enumerate(bursts):
        valid = [tx for i, tx in enumerate(b["txs"]) if i not in set(b["forged"])]
        if any(committed.get(tx) != 1 for tx in valid):
            raise AssertionError(f"burst {k + 1}: a valid tx is not in exactly one block")
        burst_heights.append([h for h in range(1, upto + 1) if set(chain["txs"][h]) & set(valid)])
        if refused[k] != b["forged"]:
            raise AssertionError(f"burst {k + 1}: the gate refused {refused[k]}, forged {b['forged']}")
    if sum(committed.values()) != sum(len(b["txs"]) - len(b["forged"]) for b in bursts):
        raise AssertionError("a block holds a tx outside the bursts' valid ones")
    if final_state.bytes_() != ref["states"][-1] or any(ref["launches"].values()):
        raise AssertionError(f"node 0's saved state differs from the host replay's, or it launched: {ref['launches']}")
    # the app hash after height h, from the replay's state saved at h, is
    # header h + 1's
    ref_apps = {json.loads(s)["last_block_height"]: json.loads(s)["app_hash"].upper() for s in ref["states"]}
    if any(chain["app_hash"][h + 1].upper() != ref_apps[h] for h in range(1, upto)):
        raise AssertionError("an app hash of node 0's chain differs from the host replay's")
    if not all(r["parts"] and r["data_hash"] for r in ref["roots"]):
        raise AssertionError(f"a block's part-set root or tx root differs on the host: {ref['roots']}")
    m = re.search(r"replayed (\d+) messages; final height/round/step: (\d+)/(\d+)/(\S+)", replay_out)
    if replay_proc.returncode != 0 or m is None or int(m.group(1)) == 0 or int(m.group(2)) not in (stored, stored + 1):
        raise AssertionError(f"`replay` on node 0's home: exit {replay_proc.returncode}, {replay_out[-400:]!r} "
                             f"{replay_err[-800:]!r}; node 0 stored {stored}")
    proposers = {h: addr_of[a] for h, a in localnet_proposers(doc, chain["round"]).items()}
    relayed = sum(len(b["txs"]) - len(b["forged"]) for b in bursts)
    exps = localnet_expected(chain, scraped, launched, ref["waves"], proposers, gate, hash_gate,
                             [sum(len(b["txs"]) for b in bursts), relayed])
    # the replica: its 4-lane commits and 5-lane aggregates under the gate on
    # the host, its reads' proofs against a header it holds: no launch
    if any(replica_launched.values()):
        raise AssertionError(f"the replica launched {replica_launched}")
    launches = {k: sum(ran[k] for ran in launched) + replica_launched[k] for k in replica_launched}
    if not all(launches[k] for k in ("b1", "ripemd160", "merkle_tree")):
        raise AssertionError(f"a kernel of the localnet's path never launched: {launches}")
    log({"phase": "localnet_path", **tag, "heights": upto, "converged_heights": converged,
         "burst_heights": burst_heights, "target_heights": targets, "rounds": chain["round"],
         "proposers": {h: proposers[h] for hs in burst_heights for h in hs},
         "block_txs": {h: len(chain["txs"][h]) for hs in burst_heights for h in hs},
         "parts": {h: chain["parts"][h] for hs in burst_heights for h in hs},
         "launches": launches, "members": [{"node": i, **scraped[i], **{k: v for k, v in e.items() if k != "launches"},
                                            "launches": e["launches"]} for i, e in enumerate(exps)],
         "replica": {"keys": len(present) + len(absent), **replica_s, "launches": replica_launched},
         "replay": {"messages": int(m.group(1)), "final": m.group(0).rsplit(" ", 1)[-1], "node0_stored": stored},
         "exit_codes": stopped, "phase_s": phase_s,
         "records": "byte-identical on the four; states and app hashes equal to the host replay"})
    return {"starts": starts, "ingest": list(feeder.bursts), "chain": chain, "burst_heights": burst_heights,
            "launches": launches, "exps": exps, "replica_s": replica_s, "reads_ms": reads_ms, "replay_s": replay_s,
            "ref": ref, "ref_wait_s": ref_wait_s, "phase_s": phase_s, "fed_s": t_fed - t_start, "stop_s": stop_s,
            "traces": traces, "probe": probe}


def localnet_time(name, power, ctx) -> None:
    """Phase 40: phase 39's run as its operator reads it: each member's
    spawn to its RPC and to its first height, and where a port process's
    start goes (startup_probe, run in a fresh process beside the replay:
    the torch import, the package, the CUDA context, the libraries' load,
    B1's first and second launch); each burst height's wall and
    /consensus_trace segments on every member; the RPC ingest rate of
    each burst; the replica's spawn to the head and its wait after the
    last burst, a verified read's latency through it; the stop, the
    replay's and the host replay's seconds."""
    tag = {"card": name, "power_limit": power}
    heights = {h for hs in ctx["burst_heights"] for h in hs}
    per_height = [[{"height": t["height"], "wall_s": t["wall_s"], "segments": t["segments"]}
                   for t in traces if t["height"] in heights] for traces in ctx["traces"]]
    log({"phase": "localnet_time", **tag, "starts": ctx["starts"], "startup_probe": ctx["probe"],
         "burst_heights": ctx["burst_heights"], "per_height": per_height,
         "ingest_txs_per_s": [b["txs_per_s"] for b in ctx["ingest"]],
         "ingest_s": [b["seconds"] for b in ctx["ingest"]],
         "replica_s": ctx["replica_s"], "read_ms": ctx["reads_ms"], "stop_s": ctx["stop_s"],
         "replay_s": ctx["replay_s"], "reference_replay_s": ctx["ref"]["seconds"],
         "reference_wait_s": ctx["ref_wait_s"], "fed_s": ctx["fed_s"], "phase_39_s": ctx["phase_s"]})

if __name__ == "__main__":
    sys.exit(main())
