"""The types a commit verification and a block build need: BlockID, Vote,
Validator, Commit, AggregateCommit, ValidatorSet, VoteSet, Block, Header
and PartSet, and the ABCI bridge of validators and headers
(`types.protobuf`)."""
