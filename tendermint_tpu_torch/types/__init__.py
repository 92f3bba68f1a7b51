"""The types a commit verification needs: BlockID, Vote, Validator, Commit,
AggregateCommit and ValidatorSet. Block, Header, PartSet and VoteSet come
with a later slice of the port."""
